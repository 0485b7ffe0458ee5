"""The port's ``FleetAutoscaler`` and ``verify_scale_payload`` against
the JAX package's: the same burn and slack evidence (a stub SLO source,
as ``tests/test_autoscaler.py`` makes it) drives both fleets to the same
verified ADDs, rejections and drain-then-REMOVEs at the same ticks, with
the streams of requests in flight across the scale events equal to
JAX's and to the port's one-shot ``generate``; the pre-flight's issues
equal JAX's on good and bad payloads."""

import numpy as np
import pytest

from skycomputing_tpu.analysis.plan_check import (
    verify_scale_payload as jax_verify_scale_payload,
)
from skycomputing_tpu_torch.analysis import verify_scale_payload
from torch_fleet_helpers import (
    port_generate_identity,
    sides,
    streams,
    supervisor_events,
    tiny_gpt,
)
from torch_test_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def gpt():
    return tiny_gpt()


class StubSlo:
    """Burn evidence as a test input (``tests/test_autoscaler.py``'s)."""

    def __init__(self):
        self.firing = ()
        self.firing_streak = 0
        self.quiet_streak = 0

    def burn(self):
        self.firing = ("stub_target",)
        self.firing_streak += 1
        self.quiet_streak = 0

    def clear(self):
        self.firing = ()
        self.firing_streak = 0

    def evaluate(self, tracer=None):
        return []


def _fleet(side, layer_cfgs, auto):
    fleet = side.fleet.ServingFleet(
        layer_cfgs, side.params, replicas=1,
        engine_kwargs=dict(num_slots=2, max_len=64, buckets=(16, 32),
                           prefill_batch=1),
        admission=side.fleet.AdmissionController(),
        supervisor=side.supervisor(), autoscaler=auto,
        devices=side.devices(8))
    fleet.slo = StubSlo()
    return fleet


def _requests(side, n):
    rng = np.random.default_rng(1)
    return [side.serving.Request(
        prompt=rng.integers(1, 500, (int(rng.integers(4, 14)),)
                            ).astype(np.int32),
        max_new_tokens=int(rng.integers(3, 6))) for _ in range(n)]


def _up_then_down(side, layer_cfgs):
    """Burn until an ADD, requests in flight, then slack until the
    drain-then-REMOVE (``tests/test_autoscaler.py``'s scale-down)."""
    auto = side.fleet.FleetAutoscaler(
        min_replicas=1, max_replicas=2, up_streak=2, down_streak=4,
        cooldown_ticks=3, chip_budget=8, slack_utilization=0.3)
    fleet = _fleet(side, layer_cfgs, auto)
    reqs = _requests(side, 8)
    for r in reqs[:4]:
        fleet.submit(r)
    for _ in range(3):
        fleet.slo.burn()
        fleet.step()
    for r in reqs[4:]:
        fleet.submit(r)
    fleet.slo.clear()
    while fleet.has_work():
        fleet.step()
    for _ in range(12):
        fleet.step()
    return fleet, reqs


def _cooldown(side, layer_cfgs):
    """Sustained burn: an ADD at ``up_streak``, the cooldown holding,
    the next ADD past it (``tests/test_autoscaler.py``'s scale-up)."""
    auto = side.fleet.FleetAutoscaler(
        min_replicas=1, max_replicas=3, up_streak=3, down_streak=50,
        cooldown_ticks=6, chip_budget=8)
    fleet = _fleet(side, layer_cfgs, auto)
    for _ in range(12):
        fleet.slo.burn()
        fleet.step()
    return fleet, []


def _infeasible(side, layer_cfgs):
    """An ADD with no chip budget: rejected by the pre-flight, the
    fleet untouched, one rejection for the cooldown."""
    auto = side.fleet.FleetAutoscaler(
        min_replicas=1, max_replicas=4, up_streak=2, cooldown_ticks=4,
        chip_budget=1)
    fleet = _fleet(side, layer_cfgs, auto)
    for _ in range(3):
        fleet.slo.burn()
        fleet.step()
    return fleet, []


def _decisions(fleet):
    return [(e["kind"], e["tick"], e.get("replica"),
             tuple(e.get("problems", ())))
            for e in fleet.autoscaler.events]


@pytest.mark.parametrize("scenario", [_up_then_down, _cooldown,
                                      _infeasible],
                         ids=["up_then_down", "cooldown", "infeasible"])
def test_autoscaler_decisions_equal_jax(gpt, scenario):
    layer_cfgs, _, sds = gpt
    (jf, jreqs), (pf, preqs) = [scenario(side, layer_cfgs)
                                for side in sides(gpt)]
    assert _decisions(pf) == _decisions(jf)
    assert pf.stats.snapshot() == jf.stats.snapshot()
    assert supervisor_events(pf) == supervisor_events(jf)
    assert [r.name for r in pf.replicas] == [r.name for r in jf.replicas]
    assert sorted(pf.metrics.names()) == sorted(jf.metrics.names())
    if preqs:
        assert all(r.status == "finished" for r in preqs)
        outs = {r.request_id: r.output() for r in preqs}
        assert streams(preqs, outs) == streams(
            jreqs, {r.request_id: r.output() for r in jreqs})
        port_generate_identity(layer_cfgs, sds, preqs, outs)
    kinds = [k for k, *_ in _decisions(pf)]
    expect = dict(up_then_down=["scale_up", "scale_down"],
                  cooldown=["scale_up", "scale_up"],
                  infeasible=["scale_rejected"])[scenario.__name__[1:]]
    assert kinds == expect


PAYLOADS = [
    dict(action="add", replicas=2, delta=1, min_replicas=1,
         max_replicas=4, chips_required=1, chips_free=2),
    dict(action="remove", replicas=3, delta=1, min_replicas=1),
    "nope",
    dict(action="explode", replicas=1, delta=1),
    dict(action="add", replicas=0, delta=1),
    dict(action="add", replicas=1, delta=True, chips_required=1,
         chips_free=1),
    dict(action="add", replicas=2, delta=1, chips_required=2,
         chips_free=1),
    dict(action="add", replicas=4, delta=1, max_replicas=4,
         chips_required=1, chips_free=8),
    dict(action="remove", replicas=1, delta=1),
    dict(action="remove", replicas=3, delta=2, min_replicas=2),
    dict(action="add", replicas=1, delta=1, min_replicas=3,
         max_replicas=2, chips_required=1, chips_free=1),
    dict(action="add", replicas=1, delta=1, pool="", chips_required=1,
         chips_free=1),
    dict(action="add", replicas=1, delta=1, pool="prefill",
         chips_required=1, chips_free=-1),
]


@pytest.mark.parametrize("payload", PAYLOADS,
                         ids=[f"payload{i}" for i in range(len(PAYLOADS))])
def test_verify_scale_payload_equals_jax(payload):
    assert verify_scale_payload(payload) == \
        jax_verify_scale_payload(payload)
