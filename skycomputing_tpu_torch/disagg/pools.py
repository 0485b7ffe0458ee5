"""DisaggFleet: role-specialized replica pools behind one handoff plane
(the port of ``skycomputing_tpu/disagg/pools.py``).

Disaggregated serving (DistServe / Splitwise, PAPERS.md) runs prefill
and decode on SEPARATE replica pools so each can specialize: prefill
replicas take big buckets and high prefill batch (throughput work,
compute-bound), decode replicas take deep slot ledgers and live-span
gathers (latency work, memory-bound).  The request's KV crosses the
pool boundary as the engine's own swap record — host page copies plus
the swap plane's checksum fold — wrapped in a
:class:`~.handoff.HandoffRecord` and conserved by a
:class:`~.handoff.HandoffLedger`:

- **export** — a prefill replica that has seeded a request's first
  token detaches it through :meth:`~..serving.engine.ServingEngine.
  export_handoff` (the public preempt/swap path verbatim); the fleet
  takes custody of the (request, swap record) pair and the ledger
  enqueues the checksummed contract.
- **deliver** — each tick the fleet walks pending records in enqueue
  order: the decode pool's admission controller gates the seat, a
  ``plan_check.verify_handoff_payload`` pre-flight rejects geometry a
  decode engine cannot hold, and the router ranks decode replicas with
  the same page-aligned prefix affinity prefill placement uses.
  :meth:`~..serving.engine.ServingEngine.import_handoff` verifies the
  checksum FIRST; the resume path is the existing swap-in path (a
  device scatter of the host pages into fresh pages of the decode
  engine's own device), with no prefill.
- **conserve** — a corrupted record fails WITH a reason and the request
  recomputes from its prompt on the decode side (committed tokens
  intact: the stream is exact either way); a prefill replica that dies
  mid-handoff leaves its in-flight records fleet-held, and the pump
  re-dispatches them — nothing strands, which is exactly the invariant
  the chaos auditor gates (``chaos/invariants.py``).

The fleet loop, routing, self-heal and autoscaling are all inherited:
this class only adds role-aware dispatch (fresh work → prefill pool,
token-carrying work → decode pool, degrading to the whole fleet when a
pool is empty — both pools run the same engine type, so serving
degraded beats stranding), per-pool admission, and the handoff pump.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..fleet.admission import AdmissionController, AdmitDecision, BATCH
from ..fleet.fleet import ServingFleet
from ..fleet.replica import DRAINING, HEALTHY, EngineReplica
from ..serving.batcher import FAILED, FINISHED, Request
from ..serving.engine import _flip_first_byte, _stage_slab_checksums
from ..telemetry import get_tracer
from ..utils import resolve_devices
from .handoff import HandoffLedger, HandoffRecord, PENDING

# the two pool roles (EngineReplica.role values)
PREFILL = "prefill"
DECODE = "decode"


def _kv_dtype_name(engine) -> str:
    """The record/geometry dtype name — one normalization for BOTH
    sides of the handoff, so a None (default) paged dtype can never
    read as a mismatch against itself."""
    return str(engine.kv_dtype or "float32")


class DisaggFleet(ServingFleet):
    """Prefill + decode replica pools with a checksummed KV handoff."""

    def __init__(
        self,
        model_cfg,
        params_list,
        *,
        prefill_replicas: int = 1,
        decode_replicas: int = 1,
        prefill_kwargs: Optional[Dict[str, Any]] = None,
        decode_kwargs: Optional[Dict[str, Any]] = None,
        prefill_admission: Optional[AdmissionController] = None,
        decode_admission: Optional[AdmissionController] = None,
        devices=None,
        **kwargs,
    ):
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError(
                "a disaggregated fleet needs >= 1 replica in EACH "
                "pool (an empty pool cannot serve its phase)"
            )
        for banned in ("replicas", "replica_specs", "admission"):
            if banned in kwargs:
                raise ValueError(
                    f"{banned!r} is not a DisaggFleet knob: pool sizes "
                    f"are prefill_replicas/decode_replicas and each "
                    f"pool carries its own admission controller"
                )
        #: per-pool engine-kwarg overrides, kept for autoscaler ADDs:
        #: a scaled-up prefill replica re-forms with the PREFILL pool's
        #: operating point (big buckets, high prefill batch, chunked
        #: prefill), a decode add with the DECODE pool's (deep slots,
        #: live-span gather) — role_spec() is the single source
        self._pool_kwargs = {
            PREFILL: dict(prefill_kwargs or {}),
            DECODE: dict(decode_kwargs or {}),
        }
        devs = resolve_devices(devices)
        specs: List[Dict[str, Any]] = []
        seq = 0
        for role, count in ((PREFILL, int(prefill_replicas)),
                            (DECODE, int(decode_replicas))):
            for _ in range(count):
                spec = dict(self._pool_kwargs[role])
                spec["role"] = role
                spec["devices"] = [devs[seq % len(devs)]]
                specs.append(spec)
                seq += 1
        self._device_seq = seq
        self.prefill_admission = (prefill_admission
                                  or AdmissionController())
        self.decode_admission = (decode_admission
                                 or AdmissionController())
        # remember which baselines the CALLER left unset: the base ctor
        # stamps the front-door controller with fleet-wide capacity,
        # but each pool's bound was sized for THAT pool
        rescale = [
            ctrl for ctrl in (self.prefill_admission,
                              self.decode_admission)
            if getattr(ctrl, "baseline_capacity", None) is None
        ]
        #: the conservation ledger every handoff passes through — the
        #: chaos auditor's gate surface
        self.ledger = HandoffLedger()
        #: fleet-held swap payloads for PENDING records: (request,
        #: engine swap record).  Host-side tensors, so a dead prefill
        #: replica cannot take an in-flight handoff down with it.
        self._payloads: Dict[int, Tuple[Request, dict]] = {}
        #: token count at delivery, per delivered request — the first
        #: tick that grows past it closes the ``kv_handoff`` trace arc
        self._handoff_watermark: Dict[int, int] = {}
        super().__init__(model_cfg, params_list,
                         replica_specs=specs,
                         admission=self.prefill_admission,
                         devices=devs, **kwargs)
        for ctrl, role in ((self.prefill_admission, PREFILL),
                           (self.decode_admission, DECODE)):
            if ctrl in rescale:
                ctrl.baseline_capacity = max(
                    self._pool_capacity_slots(role), 1
                )

    # --- pool views ---------------------------------------------------------
    def pool_replicas(self, role: str) -> List[EngineReplica]:
        """Every replica carrying ``role``, any state."""
        return [r for r in self.replicas if r.role == role]

    def _pool_healthy(self, role: str) -> List[EngineReplica]:
        return [r for r in self.pool_replicas(role)
                if r.state == HEALTHY and not r.crashed
                and r.engine is not None]

    def _pool_capacity_slots(self, role: str) -> int:
        return sum(r.engine.num_slots
                   for r in self._pool_healthy(role))

    def _pool_pending_depth(self, role: str) -> int:
        depth = sum(r.engine.stats.queue_depth
                    for r in self._pool_healthy(role))
        if role == DECODE:
            # undelivered handoffs ARE decode backlog: the decode
            # pool's front door must see work that is committed but
            # not yet seated, or the bound lies under prefill pressure
            depth += len(self.ledger.pending())
        return depth

    def role_spec(self, role: str) -> Dict[str, Any]:
        """The replica spec a per-pool scale-up builds with: the
        pool's engine operating point, its role tag, and the next
        device in the fleet's round-robin placement.  This is what
        :class:`~..fleet.autoscaler.FleetAutoscaler` (per-pool mode)
        passes to ``add_replica``."""
        if role not in self._pool_kwargs:
            raise ValueError(
                f"unknown pool role {role!r} "
                f"(have {sorted(self._pool_kwargs)})"
            )
        spec = dict(self._pool_kwargs[role])
        spec["role"] = role
        spec["devices"] = [
            self._devices[self._device_seq % len(self._devices)]
        ]
        self._device_seq += 1
        return spec

    # --- per-pool admission + role-aware dispatch ---------------------------
    def _admit_decision(self, priority: str,
                        deadline_s: Optional[float]) -> AdmitDecision:
        """Both pools gate every submit: the prefill controller judges
        the pool the request enters, the decode controller judges the
        pool it must eventually seat on — admitting prefill work a full
        decode pool can never drain would just move the queue somewhere
        the Retry-After hint cannot see.  The binding rejection names
        its pool in the decision detail."""
        tpot = self._window_percentile(self._tpot_window, 50)
        for ctrl, role in ((self.prefill_admission, PREFILL),
                           (self.decode_admission, DECODE)):
            decision = ctrl.decide(
                pending=self._pool_pending_depth(role),
                capacity_slots=self._pool_capacity_slots(role),
                priority=priority,
                deadline_s=deadline_s,
                tpot_p50_s=tpot,
            )
            if not decision.admitted:
                detail = dict(decision.detail or {})
                detail["pool"] = role
                return AdmitDecision(
                    False, reason=decision.reason,
                    retry_after_s=decision.retry_after_s,
                    detail=detail,
                )
        return decision

    def _dispatch_role(self, request: Request) -> Optional[str]:
        """Fresh work prefills; work with committed tokens (a refused
        handoff recomputing, a migrated decode) belongs to the decode
        pool.  An empty pool degrades to fleet-wide dispatch — both
        pools run the same engine type, so serving degraded beats
        parking requests against a pool that may never re-form."""
        role = DECODE if request.tokens else PREFILL
        return role if self._pool_healthy(role) else None

    # --- the handoff pump ---------------------------------------------------
    def step(self) -> None:
        super().step()
        self._pump_handoffs()
        # the pump runs after the base step's flight tap; drain the
        # ledger transitions it just produced under the tick they
        # happened on (super().step() already advanced self.tick)
        self._flight_drain_ledger(self.tick - 1)

    def _pump_handoffs(self) -> None:
        """One pass of the handoff plane, after the fleet tick: deliver
        the records already in flight, THEN export this tick's finished
        prefills, then close arcs whose request took its first decode
        tick.  Deliver-before-export means every handoff spends at
        least one tick PENDING — the in-flight window where a prefill
        death or a corruption fault can actually land (export-then-
        deliver would close the window inside one pump, and the chaos
        plane could never observe a record mid-flight)."""
        self._deliver_pending()
        self._export_ready()
        self._close_arcs()

    def _export_ready(self) -> int:
        """Detach every prefill-pool request past its first token as a
        ledgered handoff; returns how many exported this pass."""
        exported = 0
        tracer = get_tracer()
        for replica in self.pool_replicas(PREFILL):
            if (replica.state not in (HEALTHY, DRAINING)
                    or replica.crashed or replica.engine is None):
                continue
            engine = replica.engine
            ready = [rid for rid, r in engine._running.items()
                     if r.tokens and not r.done]
            for rid in ready:
                # fleet-owned requests only, and at most one handoff
                # per request EVER (a degraded-dispatch decode landing
                # on a prefill replica must not re-export)
                if (rid not in self._pending
                        or self.ledger.state_of(rid) is not None):
                    continue
                try:
                    request, payload = engine.export_handoff(rid)
                except (KeyError, ValueError):
                    continue  # raced done/preempt-refusal; next tick
                record = HandoffRecord(
                    request_id=rid,
                    source=replica.name,
                    prompt_len=int(request.prompt.size),
                    prefilled_len=int(request.effective_prompt.size),
                    index=int(payload["index"]),
                    pages=int(payload["pages"]),
                    checksum=str(payload["checksum"]),
                    slab_checksums=tuple(
                        _stage_slab_checksums(payload["data"])
                    ),
                    page_size=int(engine.page_size),
                    max_pages_per_request=int(
                        engine.max_pages_per_request
                    ),
                    stages=len(engine.stages),
                    kv_dtype=_kv_dtype_name(engine),
                    tick=int(self.tick),
                )
                self.ledger.enqueue(record)
                self._payloads[rid] = (request, payload)
                # custody moves to the fleet: un-assign so a dying
                # prefill replica's dead-drain cannot collect (and
                # double-queue) a request that already left it — the
                # request stays in _pending, so has_work() holds
                self._assignment.pop(rid, None)
                exported += 1
                if tracer is not None:
                    tracer.async_begin(
                        "kv_handoff",
                        tracer.lane("fleet", "disagg"), rid,
                        {"request": rid, "source": replica.name,
                         "pages": record.pages,
                         "prefilled_len": record.prefilled_len},
                    )
        return exported

    def _decode_geometry(self) -> Optional[Dict[str, Any]]:
        """The decode pool's per-request KV shape (any healthy member
        — the pool is homogeneous by construction); None while the
        pool has no healthy replica."""
        for replica in self._pool_healthy(DECODE):
            e = replica.engine
            return dict(
                page_size=int(e.page_size),
                max_pages_per_request=int(e.max_pages_per_request),
                stages=len(e.stages),
                kv_dtype=_kv_dtype_name(e),
            )
        return None

    def _deliver_pending(self) -> int:
        """Seat pending records on the decode pool, enqueue order.

        Deferral is not failure: a full or headless decode pool leaves
        records PENDING and the next tick retries — the ledger (and the
        chaos auditor behind it) guarantees they cannot be forgotten.
        """
        pending = self.ledger.pending()
        if not pending:
            return 0
        from ..analysis.plan_check import verify_handoff_payload

        tracer = get_tracer()
        geometry = self._decode_geometry()
        tpot = self._window_percentile(self._tpot_window, 50)
        delivered = 0
        for record in pending:
            rid = record.request_id
            held = self._payloads.get(rid)
            if held is None:  # pragma: no cover - custody is internal
                self.ledger.mark_failed(rid, "handoff payload lost")
                continue
            request, payload = held
            if geometry is None:
                break  # headless decode pool: everything defers
            # the decode pool's own front door gates each seat (raw
            # engine queue depth: the pending-handoff backlog is what
            # is being drained HERE, counting it against itself would
            # wedge the pump)
            gate = self.decode_admission.decide(
                pending=sum(r.engine.stats.queue_depth
                            for r in self._pool_healthy(DECODE)),
                capacity_slots=self._pool_capacity_slots(DECODE),
                priority=BATCH,
                tpot_p50_s=tpot,
            )
            if not gate.admitted:
                break  # pool full/blipped: defer in enqueue order
            problems = verify_handoff_payload(record.to_dict(),
                                              geometry)
            if problems:
                # verify-then-apply: a record no decode engine can
                # seat dies HERE with a reason, and the request
                # recomputes from its prompt (role-aware redispatch)
                self._payloads.pop(rid, None)
                self.ledger.mark_failed(
                    rid, f"handoff geometry mismatch: {problems[0]}"
                )
                self._end_arc(rid, tracer, outcome="geometry_reject")
                self._redispatch_one(request)
                continue
            ranked = self.router.rank(self.replica_snapshots(),
                                      prompt=request.prompt,
                                      role=DECODE)
            outcome: Optional[bool] = None
            target = ""
            for name in ranked:
                rep = self._by_name[name]
                try:
                    outcome = rep.engine.import_handoff(request,
                                                        payload)
                except ValueError:
                    continue  # request already live there; next
                target = name
                break
            if outcome is None:
                continue  # nobody could take it; stays PENDING
            self._payloads.pop(rid, None)
            if outcome:
                self.ledger.mark_delivered(rid, target)
                self._assignment[rid] = target
                self._handoff_watermark[rid] = len(request.tokens)
                self.router.record_dispatch(target, request.prompt)
                delivered += 1
            else:
                # checksum refused at import: counted on the decode
                # engine (handoff_failures), reasoned in the ledger,
                # and the request is already re-queued there to
                # recompute from its prompt — or FAILED with a verdict
                # when its resume prefix fits no bucket
                self.ledger.mark_failed(
                    rid, "checksum mismatch at import; recomputing "
                         "from prompt"
                )
                if request.status == FAILED:
                    self._end_arc(rid, tracer, outcome="failed")
                    self._fail(request, request.fail_reason
                               or "handoff record corrupted")
                else:
                    self._assignment[rid] = target
                    self._end_arc(rid, tracer, outcome="recompute")
        return delivered

    def _close_arcs(self) -> None:
        """End each delivered request's ``kv_handoff`` arc at its
        first decode tick past the delivery watermark (or terminal
        state) — the TTFT-shaped span of the pool gap itself."""
        if not self._handoff_watermark:
            return
        tracer = get_tracer()
        for rid in list(self._handoff_watermark):
            request = self._pending.get(rid) or self._finished.get(rid)
            mark = self._handoff_watermark[rid]
            if request is None:
                # swept terminal between pumps; close what we can
                del self._handoff_watermark[rid]
                self._end_arc(rid, tracer, outcome="terminal")
                continue
            if (len(request.tokens) > mark or request.done
                    or request.status in (FINISHED, FAILED)):
                del self._handoff_watermark[rid]
                self._end_arc(rid, tracer,
                              outcome="first_decode_tick",
                              tokens=len(request.tokens))

    def _end_arc(self, rid: int, tracer, **args) -> None:
        if tracer is None:
            return
        tracer.async_end("kv_handoff",
                         tracer.lane("fleet", "disagg"), rid,
                         dict(args, request=rid))

    # --- chaos surface ------------------------------------------------------
    def corrupt_handoff(self, request_id: Optional[int] = None,
                        *, force: bool = False) -> Optional[int]:
        """Flip a byte in a fleet-held handoff payload (the sanctioned
        ``handoff_corruption`` chaos hook — rot on the wire between
        pools, applied through the custody surface, never by
        monkeypatching).

        Targets ``request_id``'s pending payload when given, else the
        oldest pending one.  With ``force`` and nothing in flight, an
        export pass runs first so there is something to poison.
        Returns the corrupted request id, or None when no handoff
        exists and none can be forced — the injector logs that
        honestly instead of inventing a fault that never happened."""
        def pending_ids() -> List[int]:
            return [r.request_id for r in self.ledger.pending()
                    if r.request_id in self._payloads]

        if request_id is not None:
            if (self.ledger.state_of(request_id) != PENDING
                    or request_id not in self._payloads):
                raise KeyError(
                    f"request {request_id} holds no pending handoff"
                )
            rid: Optional[int] = request_id
        else:
            ids = pending_ids()
            rid = min(ids) if ids else None
            if rid is None and force:
                self._export_ready()
                ids = pending_ids()
                rid = min(ids) if ids else None
            if rid is None:
                return None
        _request, payload = self._payloads[rid]
        pairs = payload["data"][0]
        pairs[0] = (_flip_first_byte(pairs[0][0]), pairs[0][1])
        return rid


__all__ = [
    "DECODE",
    "DisaggFleet",
    "PREFILL",
]
