"""The port's fleet self-heal against the JAX package's, replayed on the
same weights, requests and ``FaultPlan`` (``tests/test_fleet.py``'s
sick-replica drain, slot leak and re-form rollback): streams, counters,
supervisor events and the heal trace equal, exactly.

Sickness is made by the seeded ``latency_spike`` fault, 0.4 s a tick
against a decode tick of a few milliseconds, and judged at a threshold
of 25x the replica's baseline: host noise does not sustain 25x for two
checks on the healthy replica, and the spiked one crosses it on its
first two spiked ticks, in both packages alike."""

import pytest

from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.fleet.replica import HEALTHY, RETIRED
from skycomputing_tpu_torch.dynamics import WorkerManager
from torch_fleet_helpers import assert_same_replay, replay, sides, tiny_gpt
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def gpt():
    return tiny_gpt()


def _replay_both(gpt, seed, specs, **kw):
    runs = []
    for side in sides(gpt):
        reqs = side.requests(seed, specs)
        # every callable but ``run`` is a per-package value of ``side``
        args = {k: (v(side) if callable(v) and k != "run" else v)
                for k, v in kw.items()}
        fleet, out, events = replay(side, gpt[0], reqs, **args)
        runs.append((fleet, out, events, reqs))
    assert_same_replay(gpt, *runs)
    return runs[1][0]


def test_sick_replica_drains_to_survivors(gpt):
    fleet = _replay_both(
        gpt, 6, [(5, 20), (3, 18), (12, 16), (7, 15), (6, 14), (9, 12)],
        replicas=2,
        engine_kwargs=dict(num_slots=2, max_len=64, buckets=(8, 16)),
        supervisor=lambda s: s.supervisor(sick_threshold=25.0),
        fault_injector=lambda s: s.injector(
            [dict(iter=10, kind="latency_spike", replica=1,
                  seconds=0.4, duration=4)]),
        devices=lambda s: s.devices(2))
    detects = [e for e in fleet.supervisor.events if e["kind"] == "detect"]
    assert [(e["replica"], e["reason"]) for e in detects] == [
        ("replica1", "latency")]
    assert detects[0]["score"] >= 25.0
    assert fleet.stats.reforms == 1 and fleet.stats.failed == 0
    assert all(r.state == HEALTHY for r in fleet.replicas)


def test_slot_leak_detected_and_reformed(gpt):
    fleet = _replay_both(
        gpt, 7, [(4, 12), (5, 10), (3, 14), (6, 9)], replicas=2,
        engine_kwargs=dict(num_slots=2, max_len=64, buckets=(8,)),
        supervisor=lambda s: s.supervisor(),
        fault_injector=lambda s: s.injector(
            [dict(iter=4, kind="slot_leak", replica=0, count=2)]),
        devices=lambda s: s.devices(2))
    assert "slot_leak" in [e["reason"] for e in fleet.supervisor.events
                           if e["kind"] == "detect"]
    rep = fleet.replicas[0]
    assert rep.generation >= 1 and rep.slot_accounting_ok
    assert rep.engine.free_slots == 2


def _budgeted_pool(manager_cls, layer_cfgs):
    wm = manager_cls()
    wm.load_worker_pool_from_config([
        dict(name="n0", device_config=dict(device_index=0),
             extra_config=dict(mem_limit=10_000.0))])
    worker = wm.worker_pool[0]
    worker.model_config = layer_cfgs
    worker.order = worker.rank + 1
    return wm


def test_reform_rollback_on_infeasible_reallocation(gpt):
    """Replica 0's worker budget shrinks after its build: its re-form's
    serving pre-flight rejects, nothing half-built joins the fleet, the
    failure is counted and the replica retires at ``max_reforms=1``."""
    pools = {}

    def specs(side):
        wm = _budgeted_pool(
            JaxWorkerManager if side.name == "jax" else WorkerManager,
            gpt[0])
        pools[side.name] = wm
        devs = side.devices(2)
        return [dict(worker_manager=wm, devices=[devs[0]]),
                dict(devices=[devs[1]])]

    def run(fleet, requests):
        # the world changed after replica0 was built
        for wm in pools.values():
            wm.worker_pool[0].extra_config["mem_limit"] = 0.05
        return fleet.run(requests)

    fleet = _replay_both(
        gpt, 8, [(5, 9), (3, 7), (12, 8), (7, 6), (6, 9), (9, 5)],
        replica_specs=specs, run=run,
        engine_kwargs=dict(num_slots=2, max_len=64, buckets=(8, 16)),
        supervisor=lambda s: s.supervisor(max_reforms=1),
        fault_injector=lambda s: s.injector(
            [dict(iter=3, kind="replica_crash", replica=0)]),
        devices=lambda s: s.devices(2))
    assert fleet.stats.reform_failures == 1 and fleet.stats.reforms == 0
    assert [r.state for r in fleet.replicas] == [RETIRED, HEALTHY]
    failed = [e for e in fleet.supervisor.events
              if e["kind"] == "reform_failed"]
    assert failed and "pre-flight" in failed[0]["error"]
