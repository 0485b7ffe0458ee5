"""The port's ``ServingFleet`` against the JAX package's on the same
weights, requests and ``FaultPlan``: ``tests/test_fleet.py``'s routing,
replica-kill, shed, prefix-affinity, trace and re-form-budget scenarios
replayed through both packages.  Exact: every stream (against JAX's
fleet and the port's one-shot ``generate``), the ``FleetStats``
counters with rejects by reason, the supervisor's ``(kind, replica,
tick)`` events, and the trace's ``fleet_heal`` arcs and ``fleet.drain``
/ ``fleet.migrate`` / ``fleet.reform`` spans.  The sick-replica,
slot-leak and rollback scenarios are in ``test_torch_fleet_heal.py``;
how host timing is kept out of the compared decisions is in
``tests/torch_fleet_helpers.py``."""

import numpy as np
import pytest

from skycomputing_tpu.telemetry.analysis import request_ids, request_timeline
from torch_fleet_helpers import (
    assert_same_replay,
    depth_router,
    replay,
    sides,
    tiny_gpt,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

KILL_SPECS = [(5, 9), (3, 6), (12, 7), (7, 5), (16, 6), (2, 11), (6, 8),
              (9, 4)]


@pytest.fixture(scope="module")
def gpt():
    return tiny_gpt()


def _timeline_shape(events):
    """Each request's waterfall, by submission order: its segments'
    (name, replica) and its markers' names, plus the migration count
    and completeness."""
    out = []
    for rid in request_ids(events):
        t = request_timeline(events, rid)
        out.append(dict(
            segments=sorted((s["name"], s["replica"])
                            for s in t["segments"]),
            markers=sorted(m["name"] for m in t["markers"]),
            migrations=t["migrations"], complete=t["complete"],
            orphans=t["orphan_spans"], replicas=sorted(t["replicas"])))
    return out


@pytest.fixture(scope="module")
def kill_runs(gpt):
    """Replica 0 crashes at tick 6 of a 3-replica fleet: both packages,
    traced, with the fleet time series on."""
    layer_cfgs = gpt[0]
    runs = []
    for side in sides(gpt):
        reqs = side.requests(5, KILL_SPECS)

        def run(fleet, requests):
            fleet.enable_timeseries(window=512)
            return fleet.run(requests)

        fleet, out, events = replay(
            side, layer_cfgs, reqs, run=run, replicas=3,
            engine_kwargs=dict(num_slots=2, max_len=64, buckets=(8, 16)),
            supervisor=side.supervisor(),
            fault_injector=side.injector(
                [dict(iter=6, kind="replica_crash", replica=0)]),
            devices=side.devices(3))
        runs.append((fleet, out, events, reqs))
    return runs


def test_replica_kill_replays_jax(gpt, kill_runs):
    """Routing, the kill, the migration onto survivors and the re-form:
    streams, counters, events and the heal trace equal JAX's."""
    assert_same_replay(gpt, *kill_runs)
    fleet = kill_runs[1][0]
    assert fleet.stats.migrations > 0 and fleet.stats.reforms == 1
    assert [e["kind"] for e in fleet.supervisor.events][:3] == [
        "detect", "drain", "migrate"]
    # least-loaded routing spread the 8 requests over all 3 replicas
    assert len({r.name for r in fleet.replicas}) == 3
    assert fleet.replicas[0].generation == 1


def test_migrated_request_trace_single_id(kill_runs):
    """One request id threads each waterfall across the kill, as in
    JAX's trace: the same segments by replica, the same markers, every
    request complete with no orphaned span, the lanes recycled."""
    jax_events, port_events = kill_runs[0][2], kill_runs[1][2]
    port = _timeline_shape(port_events)
    assert port == _timeline_shape(jax_events)
    migrated = [t for t in port if t["migrations"] >= 1]
    assert migrated and all(t["complete"] and t["orphans"] == 0
                            for t in port)
    assert len(migrated[0]["replicas"]) >= 2


def test_counters_monotonic_across_reform(kill_runs):
    """The re-formed replica's registry source carries the dead
    engine's counters forward: no sampled counter goes backwards, and
    the samples equal JAX's."""
    (jf, *_), (pf, *_) = kill_runs
    rep = pf.replicas[0]
    assert rep._carried["iterations"] > 0
    assert rep.stats_snapshot()["iterations"] == (
        rep._carried["iterations"] + rep.engine.stats.iterations)
    for field in ("iterations", "decode_tokens", "generated_tokens"):
        values = pf.timeseries.values(f"replica0.{field}")
        assert values and all(b >= a for a, b in zip(values, values[1:]))
        assert values == jf.timeseries.values(f"replica0.{field}")
    assert pf.timeseries.values("fleet.migrations") == \
        jf.timeseries.values("fleet.migrations")


def test_successful_reforms_refund_the_budget(gpt):
    """Three crashes of replica 0 under ``max_reforms=2``: each heal
    refunds the budget, the replica ends healthy at generation 3."""
    runs = []
    for side in sides(gpt):
        reqs = side.requests(11, [(5, 16), (3, 14), (7, 15), (6, 12),
                                  (9, 13), (4, 11)])
        fleet, out, events = replay(
            side, gpt[0], reqs, replicas=2,
            engine_kwargs=dict(num_slots=2, max_len=64, buckets=(8, 16)),
            supervisor=side.supervisor(max_reforms=2),
            fault_injector=side.injector(
                [dict(iter=t, kind="replica_crash", replica=0)
                 for t in (4, 14, 24)]),
            devices=side.devices(2))
        runs.append((fleet, out, events, reqs))
    assert_same_replay(gpt, *runs)
    fleet = runs[1][0]
    assert fleet.stats.reforms == 3 and fleet.replicas[0].generation == 3


def test_shed_under_overload_counted(gpt):
    """A 2x spike against ``max_pending=4``: the same admissions and
    rejects by reason as JAX's, every reject with a Retry-After hint,
    interactive traffic past the shed band, accepted streams equal."""
    runs, decisions = [], []
    for side in sides(gpt):
        batch = side.requests(9, [(4, 6)] * 8)
        interactive = side.requests(90, [(5, 5)] * 2)

        def run(fleet, requests, batch=batch, interactive=interactive):
            got = [fleet.submit(r) for r in batch]
            got += [fleet.submit(r, priority="interactive")
                    for r in interactive]
            decisions.append(got)
            return fleet.run()

        admission = side.fleet.AdmissionController(max_pending=4,
                                                   shed_fraction=0.5)
        fleet, out, events = replay(
            side, gpt[0], batch + interactive, run=run, replicas=2,
            engine_kwargs=dict(num_slots=2, max_len=64, buckets=(8,)),
            admission=admission, supervisor=side.supervisor(),
            devices=side.devices(2))
        runs.append((fleet, out, events, batch + interactive))
    assert_same_replay(gpt, *runs)
    jd, pd = decisions
    assert [(d.admitted, d.reason, d.replica) for d in pd] == \
        [(d.admitted, d.reason, d.replica) for d in jd]
    rejected = [d for d in pd if not d.admitted]
    assert rejected and all(d.retry_after_s > 0 for d in rejected)
    assert sum(d.admitted for d in pd[-2:]) > 0
    fleet = runs[1][0]
    assert fleet.stats.rejected == len(rejected) == sum(
        fleet.stats.rejected_by_reason.values())


def test_prefix_affinity_over_paged_kv(gpt):
    """Paged replicas with the router's key on the first KV page: each
    system prompt's requests stick to one replica, as in JAX's fleet,
    and the stickiness becomes real prefix-cache hits."""
    runs, placements = [], []
    for side in sides(gpt):
        rng = np.random.default_rng(23)
        groups = [rng.integers(1, 512, (18,)).astype(np.int32)
                  for _ in range(2)]
        reqs = []
        for _ in range(3):
            for system in groups:
                tail = rng.integers(1, 512, (3,)).astype(np.int32)
                reqs.append(side.serving.Request(
                    prompt=np.concatenate([system, tail]),
                    max_new_tokens=4))
        placed = []

        def run(fleet, requests, placed=placed):
            out = {}
            for r in requests:
                placed.append(fleet.submit(r).replica)
                out.update(fleet.run())  # affinity, not load, decides
            return out

        fleet, out, events = replay(
            side, gpt[0], reqs, run=run, replicas=2,
            engine_kwargs=dict(num_slots=2, max_len=48,
                               buckets=(8, 16, 32), kv_layout="paged",
                               page_size=8, max_concurrency=6),
            router=depth_router(side, page_size=8, affinity_slack=8.0),
            supervisor=side.supervisor(), devices=side.devices(2))
        runs.append((fleet, out, events, reqs))
        placements.append(placed)
    assert_same_replay(gpt, *runs)
    assert placements[1] == placements[0]
    assert placements[1][0::2] == [placements[1][0]] * 3
    assert placements[1][1::2] == [placements[1][1]] * 3
    snap = runs[1][0].metrics.snapshot()
    assert sum(snap[n]["prefix_hits"] for n in ("replica0",
                                                "replica1")) >= 4
