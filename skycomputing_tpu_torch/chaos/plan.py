"""Seeded, replayable fault plans: named chaos scenarios for the fleet.

The workload plane made *traffic* a value (:mod:`..workload.scenario`);
this module does the same for *faults* — the missing half of the
fleet's survival story.  A fault that only exists inside one test's
``replica.crash()`` call cannot be replayed by the next bench, pinned
by CI, or named in a bug report.  Here a fault campaign is a VALUE:

- :class:`FaultEvent` — one scheduled disruption: the fleet tick it
  fires at, a target selector (which replica, or the fleet itself), a
  kind from the sanctioned-hook vocabulary, kind-specific params, a
  duration for timed kinds, and optional seeded tick jitter;
- :class:`FaultPlan` — an ordered event list plus the workload pairing
  (which catalog scenario the plan is meant to be replayed under, with
  its sizing knobs), a fleet-shape hint, and the plan's gated
  ``recovery_budget_ticks`` — the ticks the fleet is allowed between
  its LAST injected fault and returning to a settled state.

**Kinds are sanctioned hooks, by contract.**  Every kind names one
public fault surface the fleet/serving layers expose on purpose —
:meth:`~..fleet.replica.EngineReplica.crash`, ``inject_stall``,
``fail_next_builds``, :meth:`~..serving.engine.ServingEngine.
corrupt_swap_record`, the admission controller's blip flag.  The
injector (:mod:`.injector`) refuses to apply anything else, so a chaos
plan can never monkeypatch internals into states the real system
cannot reach.

**Seeding contract** (what replayability means here): one
``random.Random(seed)``, consumed in declaration order — each event
with ``jitter_ticks > 0`` draws exactly one ``randint(-j, +j)`` tick
offset; events without jitter draw nothing.  :meth:`FaultPlan.
resolved_events` is therefore a pure function of the plan's fields,
and :meth:`FaultPlan.digest` hashes the plan identity (name + seed +
pairing) together with the resolved events, so "same seed, same fault
campaign" is one string comparison.

**Target selectors** (resolved against the live fleet at fire time by
the injector, validated syntactically here):

- ``index:N`` — the Nth entry of ``fleet.replicas`` (skipped, and
  logged as skipped, when the index is out of range);
- ``name:X`` — the replica named ``X`` (skipped when absent);
- ``pending_removal`` — the first replica the autoscaler is currently
  draining OUT of the fleet; when none is mid-removal at the event's
  tick, the event ARMS and fires at the next drain instead (the
  mid-drain-kill selector: the plan cannot know the drain's exact
  tick, so it says "kill the next one");
- ``fleet`` — no replica: the event targets fleet-level machinery
  (the only selector ``admission_blip`` accepts).

PURE STDLIB BY CONTRACT (the ``workload/scenario.py`` idiom): loadable
by file path with neither torch nor numpy installed —
``tests/test_torch_chaos.py`` loads it so.  The actuator that applies
events to a real fleet lives one module over, in :mod:`.injector`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

# the sanctioned-hook vocabulary (stable ids in plans, event logs,
# trace args and the plan_check schema — analysis/plan_check.py
# mirrors this tuple by value, tests pin the two in sync)
REPLICA_CRASH = "replica_crash"
STAGE_SLOWDOWN = "stage_slowdown"
SWAP_CORRUPTION = "swap_corruption"
REFORM_FAILURE = "reform_failure"
ADMISSION_BLIP = "admission_blip"
HANDOFF_CORRUPTION = "handoff_corruption"

FAULT_KINDS: Tuple[str, ...] = (
    REPLICA_CRASH,
    STAGE_SLOWDOWN,
    SWAP_CORRUPTION,
    REFORM_FAILURE,
    ADMISSION_BLIP,
    HANDOFF_CORRUPTION,
)

#: kinds whose selector is the FLEET itself, not any replica:
#: admission_blip flips the front door, handoff_corruption rots a
#: fleet-held prefill→decode payload (``DisaggFleet.corrupt_handoff``)
_FLEET_TARGET_KINDS = (ADMISSION_BLIP, HANDOFF_CORRUPTION)

#: selectors that name a replica (everything except ``fleet``)
_REPLICA_SELECTOR_PREFIXES = ("index:", "name:")
_BARE_SELECTORS = ("pending_removal", "fleet")


def _validate_target(kind: str, target: str) -> None:
    if kind in _FLEET_TARGET_KINDS:
        if target != "fleet":
            raise ValueError(
                f"{kind} targets fleet-level machinery; its selector "
                f"must be 'fleet', got {target!r}"
            )
        return
    if target in _BARE_SELECTORS:
        if target == "fleet":
            raise ValueError(
                f"{kind} needs a replica selector "
                f"(index:N / name:X / pending_removal), got 'fleet'"
            )
        return
    if target.startswith("index:"):
        tail = target[len("index:"):]
        if not tail.isdigit():
            raise ValueError(
                f"selector {target!r} needs a non-negative integer "
                f"after 'index:'"
            )
        return
    if target.startswith("name:"):
        if not target[len("name:"):]:
            raise ValueError(
                f"selector {target!r} needs a replica name after "
                f"'name:'"
            )
        return
    raise ValueError(
        f"unknown target selector {target!r}; known forms: index:N, "
        f"name:X, pending_removal, fleet"
    )


def _validate_params(kind: str, params: Dict[str, Any],
                     duration: int) -> None:
    """Kind-specific parameter schema — malformed plans die at build
    time, not mid-replay (the Dist-factory idiom)."""
    def _reject_extra(allowed):
        extra = sorted(set(params) - set(allowed))
        if extra:
            raise ValueError(
                f"{kind} does not take params {extra}; allowed: "
                f"{sorted(allowed)}"
            )

    if kind == REPLICA_CRASH:
        _reject_extra(())
    elif kind == STAGE_SLOWDOWN:
        _reject_extra(("seconds",))
        seconds = params.get("seconds")
        if not isinstance(seconds, (int, float)) \
                or isinstance(seconds, bool) or seconds <= 0:
            raise ValueError(
                f"{kind} needs params={{'seconds': > 0}} (the per-tick "
                f"stall the slowdown lowers to), got {params!r}"
            )
        if duration < 1:
            raise ValueError(
                f"{kind} needs duration >= 1 tick, got {duration}"
            )
    elif kind == SWAP_CORRUPTION:
        _reject_extra(("force",))
        force = params.get("force", True)
        if not isinstance(force, bool):
            raise ValueError(
                f"{kind} param 'force' must be a bool, got {force!r}"
            )
    elif kind == REFORM_FAILURE:
        _reject_extra(("builds",))
        builds = params.get("builds")
        if isinstance(builds, bool) or not isinstance(builds, int) \
                or builds < 1:
            raise ValueError(
                f"{kind} needs params={{'builds': >= 1}} (how many "
                f"consecutive rebuilds must fail), got {params!r}"
            )
    elif kind == ADMISSION_BLIP:
        _reject_extra(())
        if duration < 1:
            raise ValueError(
                f"{kind} needs duration >= 1 tick, got {duration}"
            )
    elif kind == HANDOFF_CORRUPTION:
        # mirrors swap_corruption: one optional bool — with force and
        # nothing in flight, the hook exports a handoff to poison
        _reject_extra(("force",))
        force = params.get("force", True)
        if not isinstance(force, bool):
            raise ValueError(
                f"{kind} param 'force' must be a bool, got {force!r}"
            )
    else:
        raise ValueError(
            f"unknown fault kind {kind!r}; known: {list(FAULT_KINDS)}"
        )


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled disruption inside a fault plan.

    ``params`` is a tuple of ``(key, value)`` pairs (hashable — the
    frozen-dataclass twin of a dict); :meth:`params_dict` is the
    ergonomic view.  ``duration`` only matters to timed kinds
    (``stage_slowdown`` clears its stall, ``admission_blip`` lifts its
    gate, ``duration`` ticks after firing).  ``jitter_ticks`` is the
    seeded wiggle :meth:`FaultPlan.resolved_events` lowers."""

    tick: int
    kind: str
    target: str = "index:0"
    params: Tuple[Tuple[str, Any], ...] = ()
    duration: int = 1
    jitter_ticks: int = 0

    def __post_init__(self):
        if int(self.tick) < 0:
            raise ValueError(
                f"a fault event needs tick >= 0, got {self.tick}"
            )
        if int(self.duration) < 1:
            raise ValueError(
                f"a fault event needs duration >= 1, got "
                f"{self.duration}"
            )
        if int(self.jitter_ticks) < 0:
            raise ValueError(
                f"jitter_ticks must be >= 0, got {self.jitter_ticks}"
            )
        _validate_target(self.kind, self.target)
        _validate_params(self.kind, self.params_dict(), self.duration)

    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    def key(self) -> Tuple:
        """The byte-identity view (what :meth:`FaultPlan.digest`
        hashes and the determinism smoke compares)."""
        return (self.tick, self.kind, self.target,
                tuple(sorted(self.params)), self.duration)

    def to_dict(self) -> Dict[str, Any]:
        return dict(
            tick=self.tick, kind=self.kind, target=self.target,
            params=self.params_dict(), duration=self.duration,
            jitter_ticks=self.jitter_ticks,
        )


@dataclass(frozen=True)
class FaultPlan:
    """A named, seeded fault campaign plus its workload pairing.

    ``scenario`` names the workload-catalog entry the plan is designed
    to be replayed under (``scenario_seed`` / ``rate_scale`` /
    ``ticks_scale`` are passed straight to ``get_scenario``), so
    "``reform_flap`` under its paired trace" is fully reproducible from
    the plan object alone.  ``replicas`` / ``autoscale`` are the fleet
    shape the plan assumes; ``recovery_budget_ticks`` is the gated
    time-to-healthy bound the invariant auditor enforces after the
    LAST injected fault."""

    name: str
    seed: int
    events: Tuple[FaultEvent, ...]
    scenario: str
    recovery_budget_ticks: int
    scenario_seed: int = 0
    rate_scale: float = 1.0
    ticks_scale: float = 1.0
    replicas: int = 2
    autoscale: bool = False
    #: replay against a disaggregated fleet (prefill/decode pools with
    #: the KV-handoff plane): the harness builds ``DisaggFleet`` with
    #: one prefill replica and ``replicas - 1`` decode replicas, so
    #: ``index:0`` deterministically names the prefill specialist
    disagg: bool = False
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("a fault plan needs a name")
        if not self.events:
            raise ValueError(f"plan {self.name!r} has no events")
        if not self.scenario:
            raise ValueError(
                f"plan {self.name!r} needs a paired workload scenario"
            )
        if int(self.recovery_budget_ticks) < 1:
            raise ValueError(
                f"plan {self.name!r} needs recovery_budget_ticks >= 1, "
                f"got {self.recovery_budget_ticks}"
            )
        if int(self.replicas) < 1:
            raise ValueError(
                f"plan {self.name!r} needs replicas >= 1, got "
                f"{self.replicas}"
            )
        if self.disagg and int(self.replicas) < 2:
            raise ValueError(
                f"plan {self.name!r} replays disaggregated: it needs "
                f"replicas >= 2 (one prefill + at least one decode)"
            )
        for scale, value in (("rate_scale", self.rate_scale),
                             ("ticks_scale", self.ticks_scale)):
            if float(value) <= 0:
                raise ValueError(
                    f"plan {self.name!r} {scale} must be > 0, got "
                    f"{value}"
                )

    def resolved_events(self) -> List[FaultEvent]:
        """Lower seeded jitter to concrete ticks — the deterministic
        event schedule the injector fires.  Pure: one
        ``random.Random(seed)`` consumed in declaration order, one
        draw per jittered event, so two calls (or two processes) with
        the same plan return identical schedules."""
        rng = random.Random(self.seed)
        out: List[FaultEvent] = []
        for event in self.events:
            tick = event.tick
            if event.jitter_ticks > 0:
                tick = max(0, tick + rng.randint(-event.jitter_ticks,
                                                 event.jitter_ticks))
            out.append(dataclasses.replace(event, tick=tick,
                                           jitter_ticks=0))
        return out

    @property
    def last_declared_tick(self) -> int:
        """Upper bound (pre-jitter) on when the plan stops injecting —
        sizing aid for benches pairing plans with finite traces."""
        return max(e.tick + e.jitter_ticks for e in self.events)

    def digest(self) -> str:
        """sha256 of the plan identity + its RESOLVED schedule — fault
        campaign identity as one comparable string (committed into
        bench artifacts so generator drift is visible as a hash
        change).  The seed participates directly: a different seed is
        a different campaign even when no event carries jitter."""
        h = hashlib.sha256()
        h.update(repr((self.name, self.seed, self.scenario,
                       self.scenario_seed, self.rate_scale,
                       self.ticks_scale)).encode())
        for event in self.resolved_events():
            h.update(repr(event.key()).encode())
        return h.hexdigest()

    def to_dict(self) -> Dict[str, Any]:
        """The artifact/docs/plan_check form: everything needed to
        re-declare the plan (the schedule is regenerable from this)."""
        return dict(
            name=self.name, seed=self.seed,
            scenario=self.scenario,
            scenario_seed=self.scenario_seed,
            rate_scale=self.rate_scale,
            ticks_scale=self.ticks_scale,
            replicas=self.replicas,
            autoscale=self.autoscale,
            disagg=self.disagg,
            recovery_budget_ticks=self.recovery_budget_ticks,
            description=self.description,
            events=[e.to_dict() for e in self.events],
        )

    def with_seed(self, seed: int) -> "FaultPlan":
        """The same named campaign shape under a different seed (the
        catalog's ``seed=`` plumbing)."""
        return dataclasses.replace(self, seed=int(seed))


# --------------------------------------------------------------------------
# the named-fault-plan catalog
# --------------------------------------------------------------------------
#
# One ``--plan`` flag per chaos campaign: every entry is a zero-ceremony
# builder ``(seed=0) -> FaultPlan`` registered under a stable name, so a
# bench, a test, or a postmortem can say ``reform_flap @ seed 3`` and
# mean exactly one byte-identical fault schedule.  Each plan pairs
# itself with the workload-catalog scenario whose traffic shape makes
# its faults bite (sizing follows the scenario catalog's CPU-harness
# contract: tiny GPT, 2-3 replicas, ~0.1 req/tick of service per
# replica).  The registry lives HERE (not a sibling module) so the
# whole fault plane stays ONE self-contained stdlib file the CI smoke
# loads by path.

#: name -> builder; insertion order is the documented catalog order
FAULT_PLANS: Dict[str, Callable[..., FaultPlan]] = {}


def register_fault_plan(name: str):
    """Decorator: register a fault-plan builder under ``name``
    (benches and tools resolve ``--plan`` flags against this
    registry)."""

    def deco(fn: Callable[..., FaultPlan]):
        if name in FAULT_PLANS:
            raise ValueError(
                f"fault plan {name!r} is already registered"
            )
        FAULT_PLANS[name] = fn
        return fn

    return deco


def fault_plan_names() -> List[str]:
    return list(FAULT_PLANS)


def get_fault_plan(name: str, seed: int = 0) -> FaultPlan:
    """Build a named fault plan; unknown names fail with the catalog
    in the message (the ``--plan`` flag's error surface)."""
    builder = FAULT_PLANS.get(name)
    if builder is None:
        raise ValueError(
            f"unknown fault plan {name!r}; catalog: "
            f"{fault_plan_names()}"
        )
    return builder(seed=seed)


def _crash(tick: int, target: str, jitter: int = 0) -> FaultEvent:
    return FaultEvent(tick=tick, kind=REPLICA_CRASH, target=target,
                      jitter_ticks=jitter)


@register_fault_plan("replica_crash_storm")
def replica_crash_storm(seed: int = 0) -> FaultPlan:
    return FaultPlan(
        name="replica_crash_storm", seed=seed,
        scenario="flash_crowd", rate_scale=0.8, ticks_scale=0.45,
        replicas=3, recovery_budget_ticks=45,
        events=(
            _crash(12, "index:0", jitter=2),
            _crash(26, "index:1", jitter=2),
            _crash(40, "index:2", jitter=2),
        ),
        description="three replicas crash in succession under a flash "
                    "crowd; every crash heals through drain/migrate/"
                    "re-form with zero token loss",
    )


@register_fault_plan("rolling_stragglers")
def rolling_stragglers(seed: int = 0) -> FaultPlan:
    def slow(tick, target, jitter=1):
        return FaultEvent(tick=tick, kind=STAGE_SLOWDOWN,
                          target=target,
                          params=(("seconds", 0.03),),
                          duration=10, jitter_ticks=jitter)

    return FaultPlan(
        name="rolling_stragglers", seed=seed,
        scenario="tenant_mix", rate_scale=0.8, ticks_scale=0.4,
        replicas=3, recovery_budget_ticks=60,
        events=(
            slow(8, "index:0"),
            slow(24, "index:1"),
            slow(40, "index:2"),
        ),
        description="a stage slowdown rolls across the fleet one "
                    "replica at a time; the EWMA health score may heal "
                    "stragglers away, and streams stay identical "
                    "either way",
    )


@register_fault_plan("mid_drain_kill")
def mid_drain_kill(seed: int = 0) -> FaultPlan:
    # full-size diurnal_ramp (the autoscaler acceptance scenario):
    # night 0-39, ramp 40-79, peak 80-149, evening 150-189, late
    # night 190-249.  The fleet starts at min (1 replica), burns up
    # during the peak, sheds in the tail — the pending_removal kills
    # arm just before the tail and strike whichever drain comes next.
    return FaultPlan(
        name="mid_drain_kill", seed=seed,
        scenario="diurnal_ramp", rate_scale=1.6,
        replicas=1, autoscale=True, recovery_budget_ticks=60,
        events=(
            _crash(120, "index:1", jitter=2),
            # armed BEFORE the evening slack: each kill strikes the
            # next drain the autoscaler opens, one per window
            _crash(150, "pending_removal", jitter=2),
            _crash(152, "pending_removal", jitter=2),
        ),
        description="a crash mid-peak while scaled up, then kills "
                    "aimed at whichever replica the autoscaler drains "
                    "out during the quiet tail — the mid-drain-death "
                    "removal path",
    )


@register_fault_plan("swap_corruption")
def swap_corruption(seed: int = 0) -> FaultPlan:
    def corrupt(tick, target, jitter=0):
        return FaultEvent(tick=tick, kind=SWAP_CORRUPTION,
                          target=target, params=(("force", True),),
                          jitter_ticks=jitter)

    return FaultPlan(
        name="swap_corruption", seed=seed,
        scenario="rag_shared_prefix", ticks_scale=0.4,
        replicas=2, recovery_budget_ticks=30,
        events=(
            corrupt(10, "index:0"),
            corrupt(22, "index:1", jitter=2),
            corrupt(30, "index:0"),
        ),
        description="host swap records are bit-flipped under RAG "
                    "traffic; the checksum catches every corruption "
                    "and the victim resumes by recompute, token-"
                    "identical",
    )


@register_fault_plan("reform_flap")
def reform_flap(seed: int = 0) -> FaultPlan:
    return FaultPlan(
        name="reform_flap", seed=seed,
        scenario="tenant_mix", rate_scale=0.8, ticks_scale=0.35,
        replicas=3, recovery_budget_ticks=60,
        events=(
            FaultEvent(tick=4, kind=REFORM_FAILURE, target="index:1",
                       params=(("builds", 1),)),
            _crash(6, "index:1"),
            FaultEvent(tick=20, kind=REFORM_FAILURE, target="index:2",
                       params=(("builds", 2),)),
            _crash(22, "index:2"),
        ),
        description="crashes whose re-forms fail: one replica flaps "
                    "(fail once, back off, heal), one exhausts "
                    "max_reforms and lands in quarantine — the fleet "
                    "keeps serving on survivors",
    )


@register_fault_plan("overload_then_crash")
def overload_then_crash(seed: int = 0) -> FaultPlan:
    return FaultPlan(
        name="overload_then_crash", seed=seed,
        scenario="flash_crowd", ticks_scale=0.5,
        replicas=2, recovery_budget_ticks=50,
        events=(
            FaultEvent(tick=26, kind=ADMISSION_BLIP, target="fleet",
                       duration=6),
            _crash(36, "index:0", jitter=2),
        ),
        description="an admission blip lands mid-spike (every submit "
                    "sheds, visibly), then a replica dies in the "
                    "aftermath — overload and failure composed",
    )


@register_fault_plan("prefill_kill_mid_handoff")
def prefill_kill_mid_handoff(seed: int = 0) -> FaultPlan:
    def corrupt(tick, jitter=0):
        return FaultEvent(tick=tick, kind=HANDOFF_CORRUPTION,
                          target="fleet", params=(("force", True),),
                          jitter_ticks=jitter)

    return FaultPlan(
        name="prefill_kill_mid_handoff", seed=seed,
        scenario="disagg_mix", ticks_scale=0.5,
        replicas=3, disagg=True, recovery_budget_ticks=60,
        events=(
            corrupt(10),
            # the prefill specialist dies with handoffs in flight:
            # exported records are fleet-held, so the pump re-delivers
            # them while the supervisor re-forms the pool
            _crash(18, "index:0", jitter=2),
            corrupt(34, jitter=2),
        ),
        description="a handoff payload is bit-flipped, then the "
                    "prefill specialist is killed with handoffs in "
                    "flight; the ledger conserves every record — "
                    "corrupted ones recompute with a reason, in-"
                    "flight ones re-deliver — and streams stay token-"
                    "identical",
    )


__all__ = [
    "ADMISSION_BLIP",
    "FAULT_KINDS",
    "FAULT_PLANS",
    "FaultEvent",
    "FaultPlan",
    "HANDOFF_CORRUPTION",
    "REFORM_FAILURE",
    "REPLICA_CRASH",
    "STAGE_SLOWDOWN",
    "SWAP_CORRUPTION",
    "fault_plan_names",
    "get_fault_plan",
    "register_fault_plan",
]
