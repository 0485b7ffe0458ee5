"""Shared replay harness for the fleet port's tests: one tiny GPT
(``tests/test_fleet.py``'s) in both packages, the same requests and
``FaultPlan`` through the JAX package's ``ServingFleet`` and the port's,
and the views the tests hold equal.

Host timing is kept out of every compared decision:

- the router weighs each replica's load by its wall-clock TPOT p95;
  :func:`depth_router` hands it snapshots with that pace removed, so
  both fleets route on queue depth and occupied slots (the pace
  weighting itself is held on synthetic snapshots in
  ``test_torch_fleet_policy.py``);
- the supervisor's health probe is the wall time of a decode tick;
  scenarios where sickness is not the subject build it with
  ``sick_threshold=inf``.
"""

import numpy as np
import torch

import jax

from skycomputing_tpu import dynamics as jax_dynamics
from skycomputing_tpu import fleet as jax_fleet
from skycomputing_tpu import serving as jax_serving
from skycomputing_tpu import telemetry as jax_telemetry
from skycomputing_tpu.builder import build_layer_stack as jax_build
from skycomputing_tpu.models.gpt import GptConfig, gpt_layer_configs

from skycomputing_tpu_torch import dynamics as port_dynamics
from skycomputing_tpu_torch import fleet as port_fleet
from skycomputing_tpu_torch import params_from_jax
from skycomputing_tpu_torch import serving as port_serving
from skycomputing_tpu_torch import telemetry as port_telemetry
from skycomputing_tpu_torch.models.gpt import generate, one_shot_forward

CTX = 64
INF = float("inf")
HEAL_SPANS = ("fleet.drain", "fleet.migrate", "fleet.reform")


def tiny_gpt():
    """(layer configs, JAX params, the port's state dicts)."""
    cfg = GptConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=CTX,
                    dropout_prob=0.0, dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    params = jax_build(layer_cfgs).init(jax.random.key(7),
                                        np.ones((1, 5), np.int32))
    return layer_cfgs, params, params_from_jax(jax.device_get(params),
                                               layer_cfgs)


class Side:
    """One package's fleet surface: modules, weights and devices."""

    def __init__(self, name, fleet, dynamics, serving, telemetry, params,
                 devices):
        self.name = name
        self.fleet = fleet
        self.dynamics = dynamics
        self.serving = serving
        self.telemetry = telemetry
        self.params = params
        self.devices = devices

    def supervisor(self, **kw):
        """``tests/test_fleet.py``'s fast supervisor, not sick by host
        noise unless the caller sets ``sick_threshold``."""
        defaults = dict(check_every=1, heartbeat_misses=1, grace_ticks=2,
                        baseline_ticks=3, k_checks=2, sick_threshold=INF)
        defaults.update(kw)
        return self.fleet.FleetSupervisor(**defaults)

    def injector(self, events, seed=0):
        return self.dynamics.FleetFaultInjector(
            self.dynamics.FaultPlan(list(events), seed=seed))

    def requests(self, seed, specs):
        rng = np.random.default_rng(seed)
        return [self.serving.Request(
            prompt=rng.integers(1, 512, (n,)).astype(np.int32),
            max_new_tokens=m) for n, m in specs]


def sides(gpt):
    layer_cfgs, params, sds = gpt
    return (
        Side("jax", jax_fleet, jax_dynamics, jax_serving, jax_telemetry,
             params, lambda n: list(jax.devices()[:n])),
        Side("port", port_fleet, port_dynamics, port_serving,
             port_telemetry, sds, lambda n: [torch.device("cpu")] * n),
    )


def depth_router(side, **kw):
    """A ``Router`` of ``side`` that ranks with the snapshots' TPOT pace
    removed (see the module docstring)."""
    base = side.fleet.Router

    class DepthRouter(base):
        def rank(self, snapshots, prompt=None, role=None):
            return super().rank(
                [dict(s, tpot_p95_s=None) for s in snapshots], prompt,
                role=role)

    return DepthRouter(**kw)


def replay(side, layer_cfgs, requests, *, trace=True, run=None, **fleet_kw):
    """Build ``side``'s fleet over ``layer_cfgs`` and serve
    ``requests`` (``run(fleet, requests)`` when given, else
    ``fleet.run(requests)``) with tracing on; returns the fleet, the
    outputs by request and the trace's events."""
    fleet_kw.setdefault("router", depth_router(side))
    fleet = side.fleet.ServingFleet(layer_cfgs, side.params, **fleet_kw)
    tracer = side.telemetry.enable_tracing() if trace else None
    try:
        outputs = (run(fleet, requests) if run is not None
                   else fleet.run(requests))
        events = tracer.to_chrome()["traceEvents"] if trace else []
    finally:
        if trace:
            side.telemetry.disable_tracing()
    return fleet, outputs, events


def streams(requests, outputs):
    """Outputs in request order, as lists (request ids differ between
    the packages' counters)."""
    return [np.asarray(outputs[r.request_id]).tolist()
            if r.request_id in outputs else None for r in requests]


def supervisor_events(fleet):
    return [(e["kind"], e["replica"], e["tick"])
            for e in fleet.supervisor.events]


def heal_trace(events):
    """The ``fleet_heal`` arcs (phase, args without the exception text)
    and the heal spans (name, args), in trace order."""
    arcs = [(e["ph"], {k: v for k, v in e.get("args", {}).items()
                       if k != "error"})
            for e in events if e.get("name") == "fleet_heal"]
    spans = [(e["name"], e.get("args", {})) for e in events
             if e.get("ph") == "X" and e.get("name") in HEAL_SPANS]
    return arcs, spans


def port_generate_identity(layer_cfgs, sds, requests, outputs):
    """Every finished request equal to the port's one-shot ``generate``
    on the CPU."""
    forward = one_shot_forward(layer_cfgs, sds, "cpu")
    for r in requests:
        want = generate(forward, r.prompt[None],
                        max_new_tokens=r.max_new_tokens,
                        context_length=CTX)[0]
        np.testing.assert_array_equal(outputs[r.request_id], want)


def assert_same_replay(gpt, jax_run, port_run):
    """Streams (against each other and the port's ``generate``), fleet
    counters, supervisor events and heal trace equal."""
    layer_cfgs, _, sds = gpt
    (jf, jout, jev, jreqs), (pf, pout, pev, preqs) = jax_run, port_run
    assert streams(preqs, pout) == streams(jreqs, jout)
    port_generate_identity(layer_cfgs, sds,
                           [r for r in preqs if r.request_id in pout], pout)
    assert pf.stats.snapshot() == jf.stats.snapshot()
    assert supervisor_events(pf) == supervisor_events(jf)
    assert heal_trace(pev) == heal_trace(jev)


_STDLIB_RUNNER = r'''
import importlib.abc, importlib.util, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy", "jax"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
spec = importlib.util.spec_from_file_location("stdlib_under_test",
                                              sys.argv[1])
mod = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = mod
spec.loader.exec_module(mod)
print(json.dumps(eval(sys.argv[2], {"mod": mod})))
'''


def stdlib_load(path, expression):
    """Load ``path`` by file path in a fresh interpreter where importing
    torch, numpy or jax raises, and return ``expression`` (Python over
    the loaded module ``mod``) evaluated there, through JSON."""
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", _STDLIB_RUNNER, str(path), expression],
        capture_output=True, text=True, check=True)
    return json.loads(out.stdout)
