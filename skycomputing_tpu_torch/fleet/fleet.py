"""ServingFleet: N replicated engines behind SLO-aware admission (the port
of ``skycomputing_tpu/fleet/fleet.py``).

One :class:`~..serving.ServingEngine` is one pipeline; the fleet is the
layer the ROADMAP's "millions of users" north star actually needs:

- **replication** — N engine replicas, each built through the same
  allocator/worker-manager path (and the same serving pre-flight) a
  single engine uses; Orca's iteration-level scheduling stays strictly
  per-replica, so this layer never reaches into an engine's tick.
- **routing** — :class:`~.router.Router` least-loaded + prefix-affinity
  dispatch over live replica snapshots (queue depth, free slots,
  TTFT/TPOT percentiles — the ``MetricsRegistry`` surface).
- **admission control** — :class:`~.admission.AdmissionController`
  bounded intake with priority classes, deadline-aware rejects, and
  ``Retry-After``-style hints; rejects are counted per reason, never
  silent.
- **self-heal** — :class:`~.supervisor.FleetSupervisor` detects sick or
  dead replicas (heartbeat + EWMA health score), drains them through
  the engine ``preempt`` contract, re-queues the work
  recomputation-style onto survivors (token streams provably intact —
  the ``Request`` object carries its committed tokens, so a migrated
  request resumes exactly), and re-forms the lost replica through its
  original verified builder.

The fleet loop is synchronous and single-threaded (the single-
controller design this repo runs everywhere): ``step()`` ticks every
healthy replica once, then lets the supervisor look.  Determinism is
the point — a seeded :class:`~..dynamics.faults.FleetFaultInjector`
plan replays a replica crash byte-for-byte, which is what makes the
chaos suite a real gate instead of a flake generator.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serving.batcher import FAILED, FINISHED, QueueFullError, REJECTED, Request
from ..serving.engine import ServingEngine, ServingStats
from ..telemetry import (
    FlightRecorder,
    IncidentEngine,
    LiveMetricsMixin,
    MetricsRegistry,
    SEV_CRITICAL,
    build_bundle,
    get_tracer,
)
from ..utils import Logger, resolve_devices
from ..utils.retry import retry_call
from .admission import (
    AdmissionController,
    AdmitDecision,
    BATCH,
    REPLICAS_SATURATED,
)
from .replica import (
    DRAINING,
    EngineReplica,
    HEALTHY,
    RETIRED,
    ReplicaCrashed,
)
from .router import Router
from .supervisor import FleetSupervisor, REFORMED


@dataclass
class FleetStats:
    """Fleet-level accounting (the ``ServingStats`` of the fleet layer).

    Per-replica serving counters stay on each replica's own
    ``ServingStats``; this records what only the fleet can see —
    admission outcomes, migrations, re-forms, failures.  Every request
    turned away or lost increments a counter here: degradation is only
    acceptable when it is visible.
    """

    submitted: int = 0
    admitted: int = 0
    dispatched: int = 0
    rejected: int = 0
    rejected_by_reason: Dict[str, int] = field(default_factory=dict)
    migrations: int = 0
    failed: int = 0
    reforms: int = 0
    reform_failures: int = 0
    missed_beats: int = 0
    ticks: int = 0
    # autoscaler outcomes: replicas added / drained-and-removed /
    # decisions the pre-flight (or the verified build) rejected with
    # the fleet untouched — scale events must be as countable as
    # rejections, or "it scaled down overnight" is unexplainable
    scale_ups: int = 0
    scale_downs: int = 0
    scale_rejected: int = 0
    # chaos-plane accounting: faults the injector actually applied
    # (skipped targets never count) and fault bursts the fleet fully
    # recovered from — the recovery arc's terminal counter
    faults_injected: int = 0
    recoveries_completed: int = 0
    #: incident plane: anomalies the detector rules opened over the
    #: fleet's own flight recorder (0 until ``attach_flight``)
    incidents_opened: int = 0
    # gauges (last step)
    replicas_healthy: int = 0
    replicas_total: int = 0
    #: replicas RETIRED out of rotation (re-form budget exhausted):
    #: permanently lost capacity an operator must see as a number, not
    #: infer from replicas_total minus replicas_healthy
    replicas_quarantined: int = 0
    pending: int = 0
    #: queued-but-unserved backlog (replica queues + limbo, running
    #: excluded) — the overload gauge SLO targets should burn on:
    #: ``pending`` includes running work, so a full-but-keeping-up
    #: fleet reads high on it by design
    queue_depth: int = 0
    limbo_depth: int = 0
    #: incidents currently open (gauge twin of ``incidents_opened``)
    incidents_open: int = 0

    def count_rejection(self, reason: str) -> None:
        self.rejected += 1
        self.rejected_by_reason[reason] = (
            self.rejected_by_reason.get(reason, 0) + 1
        )

    #: metric classification (telemetry.MetricsRegistry contract):
    #: counters are cumulative for the FLEET's lifetime — re-forms and
    #: reconfigurations never reset them — so time-series rates over
    #: the fleet source are always well-defined.  The percentile keys
    #: the fleet snapshot adds are gauges over rolling windows.
    FIELD_TYPES = {
        "submitted": "counter", "admitted": "counter",
        "dispatched": "counter", "rejected": "counter",
        "rejected_by_reason": "counter", "migrations": "counter",
        "failed": "counter", "reforms": "counter",
        "reform_failures": "counter", "missed_beats": "counter",
        "ticks": "counter",
        "scale_ups": "counter", "scale_downs": "counter",
        "scale_rejected": "counter",
        "faults_injected": "counter",
        "recoveries_completed": "counter",
        "incidents_opened": "counter",
        "replicas_healthy": "gauge", "replicas_total": "gauge",
        "replicas_quarantined": "gauge",
        "pending": "gauge", "queue_depth": "gauge",
        "limbo_depth": "gauge", "incidents_open": "gauge",
        "ttft_p50_s": "gauge", "ttft_p95_s": "gauge",
        "tpot_p50_s": "gauge", "tpot_p95_s": "gauge",
    }

    def snapshot(self) -> Dict[str, Any]:
        return dict(
            submitted=self.submitted,
            admitted=self.admitted,
            dispatched=self.dispatched,
            rejected=self.rejected,
            rejected_by_reason=dict(self.rejected_by_reason),
            migrations=self.migrations,
            failed=self.failed,
            reforms=self.reforms,
            reform_failures=self.reform_failures,
            missed_beats=self.missed_beats,
            ticks=self.ticks,
            scale_ups=self.scale_ups,
            scale_downs=self.scale_downs,
            scale_rejected=self.scale_rejected,
            faults_injected=self.faults_injected,
            recoveries_completed=self.recoveries_completed,
            incidents_opened=self.incidents_opened,
            replicas_healthy=self.replicas_healthy,
            replicas_total=self.replicas_total,
            replicas_quarantined=self.replicas_quarantined,
            pending=self.pending,
            queue_depth=self.queue_depth,
            limbo_depth=self.limbo_depth,
            incidents_open=self.incidents_open,
        )


class ServingFleet(LiveMetricsMixin):
    """N serving-engine replicas behind routing, admission, self-heal.

    ``model_cfg``/``params_list`` are the standard layer-config list and
    per-layer param trees every engine shares (replicas serve the same
    model; params are committed per replica device by each engine's own
    constructor).  ``replica_specs`` gives each replica its placement —
    any ``ServingEngine`` kwargs (``partition``/``devices``/
    ``worker_manager``...) — while ``engine_kwargs`` carries the shared
    operating point (slots, buckets, ``max_queue``...).  Default: one
    single-stage replica per device of ``devices``, round-robin;
    ``devices=None`` means every CUDA device, and raises where there is
    none (the tests pass ``[torch.device("cpu")] * n``).
    """

    def __init__(
        self,
        model_cfg: Sequence[Dict],
        params_list: Sequence[Any],
        *,
        replicas: int = 2,
        replica_specs: Optional[Sequence[Dict[str, Any]]] = None,
        engine_kwargs: Optional[Dict[str, Any]] = None,
        router: Optional[Router] = None,
        admission: Optional[AdmissionController] = None,
        supervisor: Optional[FleetSupervisor] = None,
        fault_injector=None,
        autoscaler=None,
        devices: Optional[Sequence[Any]] = None,
        finished_history: int = 4096,
        slo_window: int = 2048,
        slo=None,
        logger: Optional[Logger] = None,
    ):
        self._logger = logger or Logger()
        self.router = router or Router()
        self.admission = admission or AdmissionController()
        self.supervisor = supervisor or FleetSupervisor(
            logger=self._logger
        )
        self.fault_injector = fault_injector
        self.stats = FleetStats()
        # kept for replica ADDs: a scaled-up replica is built through
        # the SAME shared-operating-point builder path the fleet booted
        # with (and the same serving pre-flight), not a parallel one
        self._model_cfg = model_cfg
        self._params_list = params_list
        self._shared_kwargs = dict(engine_kwargs or {})
        self._devices = resolve_devices(devices)
        if replica_specs is None:
            replica_specs = [
                dict(devices=[self._devices[i % len(self._devices)]])
                for i in range(int(replicas))
            ]
        if not replica_specs:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: List[EngineReplica] = [
            EngineReplica(f"replica{i}", self._make_builder(spec),
                          role=str(spec.get("role", "")))
            for i, spec in enumerate(replica_specs)
        ]
        self._by_name = {r.name: r for r in self.replicas}
        # per-replica placement specs (chip accounting for the scale
        # pre-flight) + a monotonic name sequence: replica names are
        # never reused, so supervisor telemetry and metric sources
        # can't alias across scale events
        self._specs: Dict[str, Dict[str, Any]] = {
            r.name: dict(spec)
            for r, spec in zip(self.replicas, replica_specs)
        }
        self._replica_seq = len(self.replicas)
        self.tick = 0
        # fleet ledger: every admitted, unfinished request — the source
        # of truth a dead replica's recovery reads (Request objects
        # carry their committed tokens, so nothing dies with an engine)
        self._pending: Dict[int, Request] = {}
        self._assignment: Dict[int, str] = {}
        # bounded: a fleet sized for "millions of users" must not grow
        # its ledgers with lifetime traffic.  _finished is a recency
        # history (insertion-ordered, oldest evicted past the cap); the
        # SLO windows are rolling samples the percentiles read in O(w)
        # instead of walking every request ever served.
        self._finished: Dict[int, Request] = {}
        self._finished_limit = max(int(finished_history), 1)
        self._ttft_window: deque = deque(maxlen=max(int(slo_window), 1))
        self._tpot_window: deque = deque(maxlen=max(int(slo_window), 1))
        # run()'s output collector: filled incrementally at finish time,
        # so history eviction can never lose a return value mid-call
        self._collector: Optional[Dict[int, Request]] = None
        # migration limbo: drained requests no survivor could hold yet;
        # re-dispatched at the start of every step
        self._limbo: List[Request] = []
        # one registry over the whole fleet: the "fleet" source plus one
        # serving source per replica (same poller reads everything).
        # Replica sources go through stats_snapshot so counters stay
        # monotonic across re-forms (see EngineReplica).
        self.metrics = MetricsRegistry()
        self.metrics.register("fleet", self._fleet_snapshot,
                              types=FleetStats.FIELD_TYPES)
        for rep in self.replicas:
            # the replica's OWN classification: engine fields plus the
            # replica-level `generation` stamp — registering the bare
            # ServingStats types would leave `generation` untyped on
            # the exporter
            self.metrics.register(rep.name, rep.stats_snapshot,
                                  types=type(rep).FIELD_TYPES)
        # live observability (LiveMetricsMixin: enable_timeseries /
        # start_exporter; opt-in, zero-cost until enabled) plus the
        # fleet-only leg: an online SLO monitor evaluated every tick
        self.timeseries = None
        self.slo = None
        self._exporter = None
        # flight recorder + incident plane (opt-in via attach_flight;
        # zero-cost until attached — one `is not None` test per step)
        self.flight = None
        self.incidents = None
        self._flight_cursors: Dict[str, int] = {}
        self._flight_engine_marks: Dict[str, Tuple[int, int]] = {}
        self._slo_firing_prev: Tuple[str, ...] = ()
        self._bundle_events = 256
        self._bundles: deque = deque(maxlen=8)
        if slo is not None:
            self.attach_slo(slo)
        # the explicit admission bound was sized for THIS capacity;
        # stamping the baseline lets pending_bound() track live
        # healthy-replica capacity as the fleet scales (an explicit
        # baseline set by the caller wins)
        if getattr(self.admission, "baseline_capacity", None) is None:
            self.admission.baseline_capacity = self._capacity_slots()
        self.autoscaler = None
        if autoscaler is not None:
            self.attach_autoscaler(autoscaler)

    def _make_builder(self, spec: Dict[str, Any]):
        """Zero-arg engine builder for one replica spec merged over the
        fleet's shared operating point — the verified-construction
        callable both boot and every later re-form/scale-up run."""
        merged = dict(self._shared_kwargs)
        merged.update(spec)
        # "role" is replica metadata (disaggregated pool membership),
        # not an engine knob — it rides the spec so scale-ups re-form
        # into the right pool, but never reaches the engine ctor
        merged.pop("role", None)

        def build() -> ServingEngine:
            return ServingEngine(self._model_cfg, self._params_list,
                                 **merged)

        return build

    # --- live observability (LiveMetricsMixin + the SLO leg) ----------------
    #: fleet ticks are the finest sampling grain in the repo; keep a
    #: longer window than the single-engine default
    _timeseries_window = 1024

    def attach_slo(self, monitor):
        """Wire an online SLO monitor into the fleet loop.

        The monitor binds the fleet's time-series (created on demand),
        registers as the ``"slo"`` metric source, and becomes the
        optional tightening/priority signal for the admission
        controller and supervisor — unless they already carry their
        own.  ``step()`` then evaluates it every tick, emitting
        ``slo_alert`` trace instants while any target burns.
        """
        if self.slo is not None:
            raise ValueError("an SLO monitor is already attached")
        if monitor.timeseries is None:
            monitor.timeseries = self.enable_timeseries()
        self.slo = monitor
        self.metrics.register("slo", monitor.snapshot,
                              types=type(monitor).FIELD_TYPES)
        if getattr(self.admission, "slo_monitor", None) is None:
            self.admission.slo_monitor = monitor
        if getattr(self.supervisor, "slo_monitor", None) is None:
            self.supervisor.slo_monitor = monitor
        return monitor

    def attach_autoscaler(self, autoscaler):
        """Wire a :class:`~.autoscaler.FleetAutoscaler` into the fleet
        loop: ``step()`` polls it after the SLO monitor has judged the
        tick, so every decision reads this tick's freshest burn/slack
        evidence."""
        if self.autoscaler is not None:
            raise ValueError("an autoscaler is already attached")
        self.autoscaler = autoscaler
        return autoscaler

    def attach_flight(self, recorder: Optional[FlightRecorder] = None,
                      *, rules=None, quiet_ticks: int = 8,
                      bundle_events: int = 256, max_bundles: int = 8):
        """Wire the always-on flight recorder + incident plane into the
        fleet loop.

        ``step()`` then drains every subsystem's event surface into the
        recorder once per tick (the sanctioned taps: supervisor,
        autoscaler, fault injector, disagg ledger, SLO firing edges,
        engine recompile/swap-corruption counters) and runs the
        detector rules over it; a triggered rule opens an incident and
        snapshots a postmortem bundle (:meth:`bundles`).  The incident
        engine reads the fleet time-series, so one is enabled on
        attach.
        """
        if self.flight is not None:
            raise ValueError("a flight recorder is already attached")
        recorder = recorder if recorder is not None else FlightRecorder()
        self.flight = recorder
        self._bundle_events = int(bundle_events)
        self._bundles = deque(maxlen=max(int(max_bundles), 1))
        self.metrics.register("flight", recorder.snapshot,
                              types=type(recorder).FIELD_TYPES)
        self.incidents = IncidentEngine(
            recorder, self.enable_timeseries(), rules,
            quiet_ticks=quiet_ticks,
        )
        self.metrics.register("incidents", self.incidents.snapshot,
                              types=type(self.incidents).FIELD_TYPES)
        return recorder

    @property
    def bundles(self) -> List[Dict[str, Any]]:
        """The retained postmortem bundles, oldest first (bounded by
        ``attach_flight``'s ``max_bundles``)."""
        return list(self._bundles)

    def _health_snapshot(self) -> Dict[str, Any]:
        """The ``/healthz`` body: per-replica lifecycle states plus an
        overall verdict (``ok`` all healthy / ``degraded`` some /
        ``down`` none)."""
        states = {r.name: r.state for r in self.replicas}
        healthy = len(self.healthy_replicas)
        status = ("ok" if healthy == len(self.replicas)
                  else "degraded" if healthy else "down")
        incidents_open: List[Dict[str, Any]] = []
        if self.incidents is not None:
            incidents_open = [i.to_dict()
                              for i in self.incidents.open_incidents]
            # an open critical incident caps the verdict: "every
            # replica is up" is not "ok" while a detector says the
            # fleet is corrupting counters or quarantining capacity
            if status == "ok" and any(
                i["severity"] == SEV_CRITICAL for i in incidents_open
            ):
                status = "degraded"
        return dict(
            status=status,
            tick=self.tick,
            healthy=healthy,
            replicas=states,
            # the supervisor's quarantine ledger: WHO is permanently
            # out, when, and why — not just a shrinking healthy count
            quarantined={
                name: dict(entry)
                for name, entry in self.supervisor.quarantined.items()
            },
            pending=len(self._pending),
            limbo=len(self._limbo),
            slo_firing=list(self.slo.firing) if self.slo else [],
            incidents_open=incidents_open,
        )

    # --- views --------------------------------------------------------------
    def replica_by_index(self, index: int) -> EngineReplica:
        return self.replicas[index]

    def replica_snapshots(self) -> List[Dict[str, Any]]:
        return [r.snapshot() for r in self.replicas]

    @property
    def healthy_replicas(self) -> List[EngineReplica]:
        return [r for r in self.replicas
                if r.state == HEALTHY and not r.crashed]

    def _capacity_slots(self) -> int:
        return sum(r.engine.num_slots for r in self.healthy_replicas)

    def _pending_depth(self) -> int:
        depth = sum(
            r.engine.stats.queue_depth for r in self.healthy_replicas
        )
        return depth + len(self._limbo)

    # --- replica scale-up / scale-down (driven by the autoscaler) -----------
    def chip_capacity(self) -> int:
        """Total chips this fleet may place replicas on (the device
        pool it was constructed over)."""
        return len(self._devices)

    def _replica_chips(self, name: str) -> int:
        devs = self._specs.get(name, {}).get("devices")
        return len(devs) if devs else 1

    def chips_in_use(self) -> int:
        """Chips held by every live (non-retired) replica — what the
        scale pre-flight subtracts from :meth:`chip_capacity`."""
        return sum(self._replica_chips(r.name) for r in self.replicas
                   if r.state != RETIRED)

    def add_replica(
        self, spec: Optional[Dict[str, Any]] = None
    ) -> EngineReplica:
        """Verified scale-up: one new replica through the supervisor's
        budgeted re-form machinery.

        The replica is created PROVISIONAL (no engine, parked DEAD) and
        only becomes HEALTHY through ``FleetSupervisor``'s
        ``_attempt_reform`` path — the same verified builder + serving
        pre-flight a post-crash re-form runs, with the same trace arcs.
        A rejected build unwinds structurally: the provisional replica
        is dropped, no metric source was registered, no request was
        ever routable to it — the fleet is exactly as before, and the
        caller (the autoscaler) counts the rejection."""
        if spec is None:
            spec = dict(devices=[
                self._devices[self._replica_seq % len(self._devices)]
            ])
        name = f"replica{self._replica_seq}"
        replica = EngineReplica(name, self._make_builder(spec),
                                defer_build=True,
                                role=str(spec.get("role", "")))
        self.replicas.append(replica)
        self._by_name[name] = replica
        self._specs[name] = dict(spec)
        self._replica_seq += 1
        outcome = self.supervisor.retry_reform(self, replica)
        if outcome != REFORMED:
            # structural rollback: the provisional replica never held
            # an engine, a request, or a metric source
            self.replicas = [r for r in self.replicas
                             if r is not replica]
            self._by_name.pop(name, None)
            self._specs.pop(name, None)
            self.supervisor.forget_replica(name)
            raise RuntimeError(
                f"scale-up replica {name} was rejected by the verified "
                f"build ({outcome})"
            )
        self.metrics.register(name, replica.stats_snapshot,
                              types=type(replica).FIELD_TYPES)
        self.stats.replicas_total = len(self.replicas)
        self._logger.info(
            f"ServingFleet: replica {name} added "
            f"(devices={spec.get('devices')})"
        )
        return replica

    def remove_replica(self, name: str) -> str:
        """Drain-then-remove scale-down; always returns ``"draining"``:
        the replica parks DRAINING (out of rotation, requests migrated)
        and the supervisor finalizes the removal on its next poll —
        once any requests that could not migrate finish.  Two-phase by
        design: every removal has a real DRAINING window, so a replica
        dying mid-removal always exercises the same hardened
        ``finish_removal(dead=True)`` path instead of racing an inline
        finalize.  Token streams survive exactly as they do a
        sick-replica heal: graceful preempt, forced redispatch onto
        survivors."""
        replica = self._by_name.get(name)
        if replica is None:
            raise ValueError(f"unknown replica {name!r}")
        if replica.pending_removal:
            return "draining"
        survivors = [r for r in self.replicas
                     if r.state == HEALTHY and r is not replica]
        if not survivors:
            raise ValueError(
                f"cannot remove {name}: it is the last healthy replica"
            )
        replica.pending_removal = True
        migrated = self.drain_replica(replica, dead=False)
        # out of rotation BEFORE redispatch, so the migrated requests
        # can only land on survivors
        replica.state = DRAINING
        self.router.forget_replica(name)
        self.redispatch(migrated)
        return "draining"

    def finalize_removal(self, replica: EngineReplica) -> None:
        """Drop a fully-drained replica from the fleet (chips
        released, metric source unregistered, name never reused)."""
        replica.state = RETIRED
        replica.pending_removal = False
        self.replicas = [r for r in self.replicas if r is not replica]
        self._by_name.pop(replica.name, None)
        self._specs.pop(replica.name, None)
        self.router.forget_replica(replica.name)
        self.supervisor.forget_replica(replica.name)
        self.metrics.unregister(replica.name)
        self.stats.replicas_total = len(self.replicas)
        self._logger.info(
            f"ServingFleet: replica {replica.name} removed"
        )

    def reset_slo_windows(self) -> None:
        """Forget the rolling TTFT/TPOT samples (benches call this
        after compile warmup: a warm request's TTFT is dominated by
        bucket compiles and would sit in the percentile window —
        and therefore in every SLO verdict — for the whole run)."""
        self._ttft_window.clear()
        self._tpot_window.clear()

    @staticmethod
    def _window_percentile(window: deque, q: float) -> Optional[float]:
        if not window:
            return None
        return float(np.percentile(list(window), q))

    def _fleet_snapshot(self) -> Dict[str, Any]:
        snap = self.stats.snapshot()
        snap.update(
            ttft_p50_s=self._window_percentile(self._ttft_window, 50),
            ttft_p95_s=self._window_percentile(self._ttft_window, 95),
            tpot_p50_s=self._window_percentile(self._tpot_window, 50),
            tpot_p95_s=self._window_percentile(self._tpot_window, 95),
        )
        return snap

    # --- admission + dispatch ----------------------------------------------
    def submit(self, request: Request, *, priority: str = BATCH,
               deadline_s: Optional[float] = None) -> AdmitDecision:
        """Admit-or-shed, then route.  Returns the decision either way
        — a reject carries the reason and a ``Retry-After``-style hint
        and marks the request ``REJECTED``; an accept carries the
        replica it landed on."""
        self.stats.submitted += 1
        tracer = get_tracer()
        if tracer is not None:
            # the request's trace starts HERE: one stable id (the
            # request_id) threads submit -> admission -> routing ->
            # engine spans -> any migration, on one recycled lane
            lane = tracer.request_lane(request.request_id)
            if lane is not None:
                tracer.instant(
                    "submitted", lane,
                    {"request": request.request_id,
                     "priority": priority},
                )
        decision = self._admit_decision(priority, deadline_s)
        if not decision.admitted:
            self._reject(request, decision, tracer)
            return decision
        # snapshots only after the admission gate: a rejected request
        # must not pay the per-replica snapshot walk for nothing
        snaps = self.replica_snapshots()
        try:
            name = self._dispatch(request, snaps, deadline_s,
                                  role=self._dispatch_role(request))
        except QueueFullError as exc:
            decision = AdmitDecision(
                False, reason=REPLICAS_SATURATED,
                retry_after_s=self.admission.estimate_wait_s(
                    exc.queue_depth + 1, max(self._capacity_slots(), 1),
                    self._window_percentile(self._tpot_window, 50),
                ),
                detail=dict(queue_depth=exc.queue_depth),
            )
            self._reject(request, decision, tracer)
            return decision
        self.stats.admitted += 1
        self.stats.dispatched += 1
        self._pending[request.request_id] = request
        self._assignment[request.request_id] = name
        if tracer is not None:
            tracer.instant(
                "dispatch", tracer.lane("fleet", "router"),
                {"request": request.request_id, "replica": name,
                 "priority": priority},
            )
        return AdmitDecision(True, replica=name,
                             detail=decision.detail)

    def _reject(self, request: Request, decision: AdmitDecision,
                tracer) -> None:
        request.status = REJECTED
        self.stats.count_rejection(decision.reason)
        if tracer is not None:
            tracer.instant(
                "reject", tracer.lane("fleet", "admission"),
                {"request": request.request_id,
                 "reason": decision.reason,
                 "retry_after_s": decision.retry_after_s},
            )
            lane = tracer.request_lane(request.request_id,
                                       lease=False)
            if lane is not None:
                tracer.instant(
                    "rejected", lane,
                    {"request": request.request_id,
                     "reason": decision.reason,
                     "retry_after_s": decision.retry_after_s},
                )
            tracer.release_request_lane(request.request_id)

    def _admit_decision(self, priority: str,
                        deadline_s: Optional[float]) -> AdmitDecision:
        """The front-door admission verdict for one submit.  A hook so
        disaggregated fleets can gate each pool's controller separately
        (per-pool pending/capacity) while :meth:`submit` stays the one
        tracing/accounting path."""
        return self.admission.decide(
            pending=self._pending_depth(),
            capacity_slots=self._capacity_slots(),
            priority=priority,
            deadline_s=deadline_s,
            tpot_p50_s=self._window_percentile(self._tpot_window, 50),
        )

    def _dispatch_role(self, request: Request) -> Optional[str]:
        """The pool a request should route to — None on monolithic
        fleets (every replica competes).  Disaggregated fleets override
        this: fresh work goes to the prefill pool, work with committed
        tokens (a handoff fallback, a migrated decode) to the decode
        pool."""
        return None

    def _dispatch(self, request: Request,
                  snaps: Sequence[Dict[str, Any]],
                  deadline_s: Optional[float],
                  role: Optional[str] = None) -> str:
        """Walk the router's ranking until a replica's bounded queue
        accepts, under the caller's total deadline (the ``retry_call``
        budget): a saturated-or-dying fleet must give up within the
        request's patience, not after an unbounded crawl."""
        ranked = self.router.rank(snaps, prompt=request.prompt,
                                  role=role)
        if not ranked:  # admission already gates on capacity; belt+braces
            raise QueueFullError("no healthy replica", 0)
        tracer = get_tracer()
        if tracer is not None:
            # the router's decision, attributable per request: the
            # ranking it produced (truncated — the winner is what
            # matters) before the dispatch walk consumed it
            tracer.instant(
                "route", tracer.lane("fleet", "router"),
                {"request": request.request_id,
                 "ranked": ranked[:4]},
            )
        candidates = list(ranked)

        def attempt() -> str:
            name = candidates.pop(0)
            self._by_name[name].engine.submit(request)
            return name

        name = retry_call(
            attempt,
            attempts=len(candidates),
            retry_on=(QueueFullError,),
            base_delay_s=0.0, jitter=0.0, seed=0,
            deadline_s=deadline_s,
        )
        self.router.record_dispatch(name, request.prompt)
        return name

    # --- drain / migrate (called by the supervisor) -------------------------
    def drain_replica(self, replica: EngineReplica,
                      dead: bool) -> List[Request]:
        """Everything in flight on ``replica``, token streams intact.

        Sick (alive) replicas drain gracefully through the engine's
        ``preempt`` contract; a still-running request the engine could
        not preempt (resume prefix outgrew every bucket) stays on the
        engine, and the supervisor parks the replica DRAINING until it
        finishes — alive is alive.  A dead replica's engine state is
        treated as unreachable; its requests come from the fleet ledger
        — reset to queued with their committed tokens in place, the
        recomputation-resume invariant — and a non-resumable request
        there is FAILED by redispatch, visibly.
        """
        if not dead:
            return replica.engine.drain()
        tracer = get_tracer()
        migrated: List[Request] = []
        for rid, name in list(self._assignment.items()):
            if name != replica.name:
                continue
            # un-assign NOW: a collected request that later parks in
            # limbo must not keep pointing at this replica, or a second
            # death of the (re-formed) replica would collect it again
            # and double-queue the same token stream
            self._assignment.pop(rid)
            r = self._pending.get(rid)
            if r is None or r.status == FINISHED or r.done:
                continue
            r.slot = None
            # an involuntary eviction IS a preemption — honest per-
            # request accounting, and the marker that shields a not-yet-
            # started migrant from ever being a shed victim downstream
            r.preemptions += 1
            migrated.append(r)
            if tracer is not None:
                # the dead engine can't close its own segments (its
                # state is unreachable by contract), so the fleet —
                # holding the ledger AND the request's open trace mark
                # — ends whatever was in flight and stamps the
                # migration: no orphaned spans, and the waterfall shows
                # exactly where replica A's story stops
                self._trace_interrupt(r, tracer, replica.name)
        return migrated

    def _trace_interrupt(self, request: Request, tracer,
                         replica_name: str) -> None:
        """Close a collected request's open segment at its (dead)
        replica's name and stamp the ``migrate`` marker."""
        lane = tracer.request_lane(request.request_id, lease=False)
        mark_decode = request.trace_marks.pop("decode", None)
        mark_prefill = request.trace_marks.pop("prefill", None)
        mark_queued = request.trace_marks.pop("queued", None)
        if lane is not None:
            base = {"request": request.request_id,
                    "replica": replica_name, "interrupted": True}
            if mark_decode is not None:
                tracer.complete(
                    "decode", lane, mark_decode,
                    dict(base, tokens=len(request.tokens)),
                )
            elif mark_prefill is not None:
                # a chunked prefill cut short by its replica's death
                tracer.complete("prefill", lane, mark_prefill, base)
            elif mark_queued is not None:
                tracer.complete("queue_wait", lane, mark_queued, base)
            tracer.instant(
                "migrate", lane,
                {"request": request.request_id, "from": replica_name},
            )

    def redispatch(self, requests: Sequence[Request]) -> Tuple[int, int]:
        """Place migrated requests on survivors; (placed, parked).

        Placement is FORCED (already-admitted requests are never
        re-judged by a survivor's bound); a request parks in limbo only
        while NO healthy replica exists, retrying every step, and one
        no replica can EVER hold (bucket infeasibility everywhere)
        fails visibly."""
        placed = parked = 0
        for r in requests:
            if r.status == FINISHED or r.done:
                continue
            outcome = self._redispatch_one(r)
            if outcome == "placed":
                placed += 1
            elif outcome == "parked":
                parked += 1
        self.stats.limbo_depth = len(self._limbo)
        return placed, parked

    def _redispatch_one(self, request: Request) -> str:
        snaps = self.replica_snapshots()
        ranked = self.router.rank(snaps, prompt=request.prompt,
                                  role=self._dispatch_role(request))
        infeasible = 0
        for name in ranked:
            rep = self._by_name[name]
            try:
                # force: this request was already admitted — the fleet's
                # promise survives the replica it was first placed on,
                # so the survivor's bound/shed policy does not re-judge
                # it (transient overshoot is bounded by the dead
                # replica's former load)
                rep.engine.submit(request, force=True)
            except ValueError:
                infeasible += 1
                continue
            self._assignment[request.request_id] = name
            self.stats.migrations += 1
            self.router.record_dispatch(name, request.prompt)
            return "placed"
        if ranked and infeasible == len(ranked):
            self._fail(request,
                       "no replica's bucket set fits the resume prefix")
            return "failed"
        # parked requests are owned by the fleet, not any replica: a
        # stale assignment here would let a dead-drain collect the same
        # request a second time
        self._assignment.pop(request.request_id, None)
        self._limbo.append(request)
        tracer = get_tracer()
        if tracer is not None:
            lane = tracer.request_lane(request.request_id,
                                       lease=False)
            if lane is not None:
                tracer.instant(
                    "limbo", lane,
                    {"request": request.request_id},
                )
        return "parked"

    def _fail(self, request: Request, why: str) -> None:
        request.status = FAILED
        request.fail_reason = why
        self._pending.pop(request.request_id, None)
        self._assignment.pop(request.request_id, None)
        self.stats.failed += 1
        self._logger.warning(
            f"ServingFleet: request {request.request_id} failed: {why}"
        )
        tracer = get_tracer()
        if tracer is not None:
            tracer.instant(
                "request_failed", tracer.lane("fleet", "supervisor"),
                {"request": request.request_id, "why": why},
            )
            lane = tracer.request_lane(request.request_id,
                                       lease=False)
            if lane is not None:
                tracer.instant(
                    "failed", lane,
                    {"request": request.request_id, "why": why},
                )
            tracer.release_request_lane(request.request_id)

    # --- the fleet loop -----------------------------------------------------
    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._limbo)

    def step(self) -> None:
        """One fleet iteration: inject scheduled faults, retry limbo,
        tick every healthy replica, then let the supervisor look."""
        if self.fault_injector is not None:
            self.fault_injector.on_tick(self)
        if self._limbo:
            limbo, self._limbo = self._limbo, []
            self.redispatch(limbo)
        for replica in self.replicas:
            # DRAINING replicas still tick: they are finishing requests
            # that cannot migrate — out of rotation, not out of work
            if replica.state not in (HEALTHY, DRAINING):
                continue
            stats0 = replica.engine.stats
            waves0 = stats0.prefill_waves
            decoded0 = stats0.decode_tokens
            t0 = time.perf_counter()
            try:
                replica.tick(self.tick)
            except ReplicaCrashed:
                replica.missed_beats += 1
                self.stats.missed_beats += 1
                continue
            # honest compute timing: tick() ends in the engine's own
            # device-to-host copy of its tokens
            tick_s = time.perf_counter() - t0
            stats = replica.engine.stats
            if (replica.state == HEALTHY
                    and stats.prefill_waves == waves0
                    and stats.decode_tokens > decoded0):
                # the health probe is the PURE-DECODE tick: decode is
                # fixed-shape ([slots, 1] against the slab), so its wall
                # time is workload-independent and comparable across the
                # replica's whole life.  Ticks that ran a prefill wave
                # (cost scales with the wave, not the host's health) or
                # did nothing would poison the EWMA baseline and let the
                # fleet's own admission rhythm read as a straggler.  (The
                # reference also skips ticks that compiled; PyTorch runs
                # eagerly and the engine never compiles.)
                self.supervisor.observe_tick(replica, tick_s)
        self.supervisor.poll(self)
        self._sweep_terminal()
        self.stats.ticks += 1
        self.stats.replicas_healthy = len(self.healthy_replicas)
        self.stats.replicas_total = len(self.replicas)
        self.stats.replicas_quarantined = sum(
            1 for r in self.replicas if r.state == RETIRED
        )
        self.stats.pending = len(self._pending)
        self.stats.queue_depth = self._pending_depth()
        self.stats.limbo_depth = len(self._limbo)
        # observability tail: sample the tick's final state, then judge
        # it — the SLO monitor must see the sample it alerts on, and
        # the autoscaler polls LAST so its sustained-burn/slack
        # evidence includes this very tick's verdict
        if self.timeseries is not None:
            self.timeseries.sample()
        if self.slo is not None:
            self.slo.evaluate(get_tracer())
        if self.autoscaler is not None:
            self.autoscaler.poll(self)
        if self.flight is not None:
            # the black box drains every subsystem's event surface
            # AFTER the autoscaler, so this tick's whole story — fault,
            # heal, scale, SLO verdict — is in the ring before the
            # detector rules judge it
            self._flight_tap()
            self._incident_tick()
        self.tick += 1

    # --- flight recorder taps (the sanctioned black-box feeds) --------------
    #: supervisor event kind -> flight vocabulary
    _SUPERVISOR_KINDS = {
        "detect": "replica_detect",
        "drain": "replica_drain",
        "migrate": "replica_migrate",
        "removed": "replica_removed",
        "retired": "replica_retired",
        "reform_failed": "reform_failed",
        "reformed": "replica_reformed",
    }
    _AUTOSCALER_KINDS = ("scale_up", "scale_down", "scale_rejected")
    _LEDGER_KINDS = {
        "enqueue": "handoff_enqueued",
        "deliver": "handoff_delivered",
        "fail": "handoff_failed",
    }
    #: wall-microsecond width of the trace slice a bundle embeds
    _bundle_trace_window_us = 2_000_000.0

    def _drain_list(self, cursor_key: str, source: list) -> list:
        """Cursor-drain a component's append-only event list: the tap
        reads each entry exactly once, and components never know the
        recorder exists."""
        start = self._flight_cursors.get(cursor_key, 0)
        fresh = source[start:]
        self._flight_cursors[cursor_key] = len(source)
        return fresh

    def _flight_tap(self) -> None:
        """Drain every subsystem's event surface into the flight
        recorder (once per tick, end of ``step()``).  Components keep
        their own append-only logs; this tap is the single sanctioned
        feed, so the recorder stays pure stdlib and no subsystem grows
        a recorder dependency."""
        rec = self.flight
        tick = self.tick
        inj = self.fault_injector
        if inj is not None:
            applied = getattr(inj, "applied", None)
            if applied is not None:
                for e in self._drain_list("chaos.applied", applied):
                    rec.record(
                        int(e.get("tick", tick)), "chaos",
                        "fault_applied" if e.get("ok")
                        else "fault_skipped",
                        subject=str(e.get("target") or ""), detail=e,
                    )
            recoveries = getattr(inj, "recoveries", None)
            if recoveries is not None:
                for e in self._drain_list("chaos.recoveries",
                                          recoveries):
                    rec.record(int(e.get("settled_tick", tick)),
                               "chaos", "recovery_settled", detail=e)
        for e in self._drain_list("supervisor", self.supervisor.events):
            kind = self._SUPERVISOR_KINDS.get(e.get("kind"))
            if kind is None:
                continue
            rec.record(int(e.get("tick", tick)), "supervisor", kind,
                       subject=str(e.get("replica") or ""), detail=e)
        if self.autoscaler is not None:
            events = getattr(self.autoscaler, "events", None)
            if events is not None:
                for e in self._drain_list("autoscaler", events):
                    kind = e.get("kind")
                    if kind not in self._AUTOSCALER_KINDS:
                        continue
                    rec.record(
                        int(e.get("tick", tick)), "autoscaler", kind,
                        subject=str(e.get("replica")
                                    or e.get("pool") or ""),
                        detail=e,
                    )
        # serving lane: per-replica recompile / swap-corruption COUNTER
        # DELTAS — the engine is never modified to push; the fleet (the
        # only layer allowed to import both) reads the stats it already
        # walks each tick
        for replica in self.replicas:
            engine = getattr(replica, "engine", None)
            stats = getattr(engine, "stats", None)
            if stats is None:
                continue
            compiles = int(getattr(stats, "compiles", 0))
            corrupt = int(getattr(stats, "swap_corruptions", 0))
            mark = self._flight_engine_marks.get(replica.name)
            if mark is None or compiles < mark[0] or corrupt < mark[1]:
                # first sight, or a re-formed engine reset its stats:
                # re-baseline silently (re-form warmup compiles are the
                # supervisor's story, not steady-state anomalies)
                self._flight_engine_marks[replica.name] = (compiles,
                                                           corrupt)
                continue
            if compiles > mark[0]:
                rec.record(tick, "serving", "recompile",
                           subject=replica.name,
                           detail={"count": compiles - mark[0],
                                   "total": compiles})
            if corrupt > mark[1]:
                rec.record(tick, "serving", "swap_corrupt",
                           subject=replica.name,
                           detail={"count": corrupt - mark[1],
                                   "total": corrupt})
            self._flight_engine_marks[replica.name] = (compiles,
                                                       corrupt)
        # slo lane: firing-set EDGES (alert raised / cleared), not the
        # level — the recorder logs transitions, the timeseries holds
        # the level
        if self.slo is not None:
            firing = tuple(self.slo.firing)
            prev, now = set(self._slo_firing_prev), set(firing)
            for target in sorted(now - prev):
                rec.record(tick, "slo", "slo_alert", subject=target)
            for target in sorted(prev - now):
                rec.record(tick, "slo", "slo_clear", subject=target)
            self._slo_firing_prev = firing
        self._flight_drain_ledger(tick)

    def _flight_drain_ledger(self, tick: int) -> None:
        """Drain the disagg handoff ledger's event list (no-op on
        monolithic fleets).  Split out of :meth:`_flight_tap` because
        ``DisaggFleet`` pumps handoffs AFTER the base step — its pump
        calls this again so same-tick ledger transitions land in the
        ring under the tick they happened on."""
        if self.flight is None:
            return
        events = getattr(getattr(self, "ledger", None), "events", None)
        if events is None:
            return
        for e in self._drain_list("disagg", events):
            kind = self._LEDGER_KINDS.get(e.get("kind"))
            if kind is None:
                continue
            # which decode replica a handoff lands on is routing
            # resolution (least-loaded / latency-scored — wall-state
            # dependent by design), so it rides under the det-excluded
            # "resolved" key: live views keep it, deterministic logs
            # and bundle digests never see it
            detail = dict(e)
            resolved = {key: detail.pop(key)
                        for key in ("source", "target")
                        if key in detail}
            if resolved:
                detail["resolved"] = resolved
            self.flight.record(
                int(e.get("tick", tick)), "disagg", kind,
                subject="", detail=detail,
            )

    def _incident_tick(self) -> None:
        """Run the detector rules over this tick's recorded events;
        every newly opened incident snapshots its postmortem bundle
        HERE — at detection time, while the evidence is still in the
        ring — not when someone asks for it later."""
        engine = self.incidents
        if engine is None:
            return
        opened, closed = engine.evaluate(self.tick)
        tracer = get_tracer()
        for inc in closed:
            self.flight.record(
                self.tick, "fleet", "incident_closed",
                subject=inc.rule,
                detail={"incident_id": inc.incident_id,
                        "opened_tick": inc.opened_tick},
            )
            if tracer is not None:
                tracer.instant(
                    "incident_closed",
                    tracer.lane("fleet", "incidents"),
                    {"rule": inc.rule, "incident": inc.incident_id},
                )
        for inc in opened:
            bundle = self._snapshot_incident_bundle(inc)
            self._bundles.append(bundle)
            self.flight.record(
                self.tick, "fleet", "incident_opened",
                subject=inc.rule,
                detail={"incident_id": inc.incident_id,
                        "severity": inc.severity,
                        "bundle_digest": inc.bundle_digest},
            )
            if tracer is not None:
                tracer.instant(
                    "incident_opened",
                    tracer.lane("fleet", "incidents"),
                    {"rule": inc.rule, "incident": inc.incident_id,
                     "severity": inc.severity},
                )
            self._logger.warning(
                f"ServingFleet: incident {inc.incident_id} opened "
                f"({inc.severity}): {inc.reason}"
            )
        # this is the engine's only evaluator, so the opened delta is
        # exact and the stats counter stays monotone
        self.stats.incidents_opened += len(opened)
        self.stats.incidents_open = engine.open_count

    def _topology_snapshot(self) -> Dict[str, Any]:
        """Deterministic fleet shape: per-replica lifecycle + per-pool
        (role) rollup — the 'what did the fleet look like' a bundle
        stamps, and part of the bundle's digest-covered identity."""
        replicas: Dict[str, Any] = {}
        pools: Dict[str, Dict[str, int]] = {}
        for r in self.replicas:
            replicas[r.name] = dict(
                state=r.state, role=r.role,
                generation=int(getattr(r, "generation", 0)),
                pending_removal=bool(getattr(r, "pending_removal",
                                             False)),
            )
            pool = pools.setdefault(r.role or "default",
                                    {"replicas": 0, "healthy": 0})
            pool["replicas"] += 1
            if r.state == HEALTHY and not r.crashed:
                pool["healthy"] += 1
        return dict(tick=self.tick, replicas=replicas, pools=pools)

    def _snapshot_incident_bundle(self,
                                  incident) -> Dict[str, Any]:
        tracer = get_tracer()
        trace_slice: List[Dict[str, Any]] = []
        if tracer is not None:
            since = max(0.0,
                        tracer.now() - self._bundle_trace_window_us)
            trace_slice = tracer.to_chrome(
                since_us=since)["traceEvents"]
        summary: Dict[str, Any] = {}
        if self.timeseries is not None:
            summary = self.timeseries.summary(points=16)
        audit = getattr(getattr(self, "ledger", None), "audit", None)
        return build_bundle(
            incident, self.flight,
            flight_events=self._bundle_events,
            metrics_summary=summary,
            trace_slice=trace_slice,
            healthz=self._health_snapshot(),
            topology=self._topology_snapshot(),
            ledger_audit=audit() if callable(audit) else {},
        )

    def _sweep_terminal(self) -> None:
        """Move finished requests to the fleet ledger's done side, and
        account engine-level sheds (a replica's bounded queue displaced
        a fleet-dispatched request) as fleet rejections."""
        for rid, r in list(self._pending.items()):
            if r.status == FINISHED:
                self._finished[rid] = self._pending.pop(rid)
                self._assignment.pop(rid, None)
                if self._collector is not None:
                    self._collector[rid] = r
                ttft, tpot = r.ttft_s(), r.tpot_s()
                if ttft is not None:
                    self._ttft_window.append(ttft)
                if tpot is not None:
                    self._tpot_window.append(tpot)
                while len(self._finished) > self._finished_limit:
                    oldest = next(iter(self._finished))
                    del self._finished[oldest]
            elif r.status == REJECTED:
                self._pending.pop(rid)
                self._assignment.pop(rid, None)
                self.stats.count_rejection("engine_shed")
            elif r.status == FAILED:
                self._pending.pop(rid, None)
                self._assignment.pop(rid, None)
        # nobody left to serve and nobody coming back: fail limbo
        # loudly instead of spinning forever
        if self._limbo and all(r.state == RETIRED
                               for r in self.replicas):
            for r in self._limbo:
                self._fail(r, "every replica is retired")
            self._limbo = []

    def run(
        self,
        requests: Optional[Sequence[Request]] = None,
        *,
        priority: str = BATCH,
        max_ticks: int = 100_000,
    ) -> Dict[int, np.ndarray]:
        """Submit ``requests`` and drive ``step`` until the fleet
        drains; returns ``{request_id: prompt + generated tokens}`` for
        everything that finished during the call (rejected/failed
        requests are visible on their ``status`` and in ``stats``).
        Outputs are collected incrementally at finish time, so the
        bounded finished-history eviction can never lose one mid-call."""
        collector: Dict[int, Request] = {}
        self._collector = collector
        try:
            for r in requests or ():
                self.submit(r, priority=priority)
            for _ in range(max_ticks):
                if not self.has_work():
                    break
                self.step()
            else:  # pragma: no cover - scheduler liveness guard
                raise RuntimeError(
                    f"serving fleet did not drain in {max_ticks} ticks "
                    f"(pending={len(self._pending)}, "
                    f"limbo={len(self._limbo)})"
                )
        finally:
            self._collector = None
        return {rid: r.output() for rid, r in collector.items()}

    @property
    def finished_requests(self) -> List[Request]:
        """The most recent finished requests (bounded recency history —
        ``finished_history`` — not lifetime traffic)."""
        return list(self._finished.values())


__all__ = ["FleetStats", "ServingFleet"]
