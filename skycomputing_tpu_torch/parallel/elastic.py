"""Elastic re-formation: survivors re-form the world after a peer dies
(the port of ``skycomputing_tpu/parallel/elastic.py``).

Detection exists (:class:`~.heartbeat.PeerHeartbeat`, the process
group's own errors); this module adds the RECOVERY half: after a
failure, the surviving nodes agree on a new, smaller world and resume
training from the last checkpoint.

Why supervisors, not in-process re-initialization
-------------------------------------------------
A collective that lost a peer cannot be cancelled from Python, and a
process group that saw a peer die is not usable again (NCCL's watchdog
may even tear the process down with a signal).  Recovery therefore
happens one level up, like torchelastic: a lightweight per-node
**supervisor** launches the trainer, watches for abnormal exit (a
backend error, heartbeat abort rc=17, a signal), re-rendezvouses with
the other surviving supervisors, and relaunches the trainer in a
generation-(g+1) world whose coordinator and membership come from the
rendezvous.  Checkpoints are layer-indexed, so they restore under any
partition and world size.

Rendezvous is a shared directory, so a Slurm cluster or a single host
both work with no extra service.  Its files are byte for byte the JAX
package's, so either package's :class:`FileRendezvous` reads what the
other's wrote:

    nodes/<node_id>.alive     mtime-refreshed liveness beacons
    realloc.json              a staged re-allocation payload
    planned_gen_<g>.json      the marker of a planned re-form
    gen_<g>/world.json        the coordinator's world spec for generation g

Protocol per re-formation round: every surviving supervisor refreshes its
beacon and waits ``settle_s``; the membership is every node whose beacon
is fresher than ``stale_s``; the member with the LOWEST node id becomes
coordinator, binds a free port, and publishes ``world.json``; everyone
else polls for it, finds its rank by position, and relaunches its trainer
with ``SKYTPU_COORDINATOR``/``SKYTPU_NUM_PROCESSES``/``SKYTPU_PROCESS_ID``
(the exact env :func:`~.multihost.initialize_from_env` consumes).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..utils import Logger, atomic_write, retry_call
from .multihost import PEER_TIMEOUT_ENV

#: trainer exit codes the supervisor treats as "peer failure — re-form":
#: 17 is HeartbeatHook's abort code; nonzero anything else is a crash
#: (a backend error, or a signal from NCCL's watchdog).
HEARTBEAT_ABORT_RC = 17

#: trainer exit code for a PLANNED re-formation: the SelfHealHook detected
#: a straggler, snapshotted to the parameter server, staged its measured
#: device-speed scales in the rendezvous dir, and exited so the supervisor
#: can re-form the SAME membership with the new allocation carried through
#: ``world.json``.  Distinct from a crash: it does not count against
#: ``max_reforms`` (it has its own ``max_reallocs`` budget).
REALLOC_RC = 43


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _routable_host() -> str:
    """Address other nodes can reach this one at, for world.json.

    ``SKYTPU_ELASTIC_HOST`` overrides (multi-NIC clusters pin their data
    interface, as the reference's ``experiment/config.py`` pinned
    ``GLOO_SOCKET_IFNAME``); otherwise the hostname's resolved address,
    falling back to loopback for single-machine worlds.  The port comes
    from :func:`_free_port` and is free when published; should another
    process take it before the new world's rank 0 binds it, that
    trainer fails and the supervisor re-forms, as after any crash.
    """
    override = os.environ.get("SKYTPU_ELASTIC_HOST")
    if override:
        return override
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class FileRendezvous:
    """Shared-directory membership + world agreement (see module doc)."""

    def __init__(self, root: str, node_id: int, stale_s: float = 6.0,
                 settle_s: float = 2.0, timeout_s: float = 120.0,
                 logger: Optional[Logger] = None):
        self.root = root
        self.node_id = int(node_id)
        self.stale_s = float(stale_s)
        self.settle_s = float(settle_s)
        self.timeout_s = float(timeout_s)
        self._logger = logger or Logger()
        self._warned_strays: set = set()
        os.makedirs(os.path.join(root, "nodes"), exist_ok=True)

    # --- liveness beacons -------------------------------------------------
    @property
    def _beacon(self) -> str:
        return os.path.join(self.root, "nodes", f"{self.node_id}.alive")

    def refresh_beacon(self) -> None:
        with open(self._beacon, "w") as fh:
            fh.write(str(time.time()))

    def alive_nodes(self) -> List[int]:
        """Node ids whose beacons are fresher than ``stale_s``.

        Stray non-numeric ``*.alive`` names (editor droppings, a confused
        operator's files in the shared dir) are skipped with a log line —
        one junk file must not crash every supervisor's membership scan.
        """
        out = []
        now = time.time()
        ndir = os.path.join(self.root, "nodes")
        for name in os.listdir(ndir):
            if not name.endswith(".alive"):
                continue
            try:
                node_id = int(name[: -len(".alive")])
            except ValueError:
                if name not in self._warned_strays:
                    # once per name: form_world polls this every 0.2s and
                    # a junk file must not flood the formation-window log
                    self._warned_strays.add(name)
                    self._logger.info(
                        f"ignoring stray rendezvous beacon {name!r} in "
                        f"{ndir}"
                    )
                continue
            path = os.path.join(ndir, name)
            try:
                age = now - os.stat(path).st_mtime
            except OSError:
                continue
            if age <= self.stale_s:
                out.append(node_id)
        return sorted(out)

    # --- realloc payload --------------------------------------------------
    @property
    def _payload_path(self) -> str:
        return os.path.join(self.root, "realloc.json")

    def stage_payload(self, payload: Dict) -> None:
        """Atomically stage data for the NEXT world formation (the
        self-heal hook's measured device-speed scales).  The coordinator
        consumes it into ``world.json`` as ``spec['allocation']`` so every
        member's relaunched trainer sees the same measurement."""
        atomic_write(self._payload_path, json.dumps(payload),
                     tmp_suffix=f".tmp{self.node_id}")

    def has_staged_payload(self) -> bool:
        """A realloc payload is staged and not yet consumed — some node's
        self-heal hook has requested a planned re-form this round."""
        return os.path.exists(self._payload_path)

    # --- planned-reform markers -------------------------------------------
    def _marker_path(self, generation: int) -> str:
        return os.path.join(self.root, f"planned_gen_{generation}.json")

    def mark_planned(self, generation: int) -> None:
        """Durably mark generation ``generation`` as a PLANNED re-form.

        Written by the supervisor that observed its own trainer exit with
        ``REALLOC_RC``, BEFORE re-forming.  Unlike the payload (consumed
        by the coordinator, possibly seconds before slower peers' trainers
        die from the process group's timeout), the marker
        persists, so every peer classifies the round as planned no matter
        how late it checks."""
        atomic_write(self._marker_path(generation),
                     json.dumps({"node": self.node_id}),
                     tmp_suffix=f".tmp{self.node_id}")

    def planned_marked(self, generation: int) -> bool:
        return os.path.exists(self._marker_path(generation))

    def take_payload(self) -> Optional[Dict]:
        """Read-and-consume the staged payload (coordinator side).

        Transient read faults are retried like the ``world.json`` read;
        only genuinely corrupt content is discarded — a transient must
        not destroy the self-heal measurement it briefly hid."""
        path = self._payload_path
        if not os.path.exists(path):
            return None

        def read_payload():
            with open(path) as fh:
                return json.load(fh)

        try:
            # deadline: the payload read happens inside a formation
            # round, and its worst-case backoff (~5 s) must never eat a
            # short formation window on its own
            payload = retry_call(
                read_payload, retry_on=(OSError, json.JSONDecodeError),
                attempts=4, deadline_s=self.timeout_s,
                logger=self._logger, describe=f"read {path}",
            )
        except json.JSONDecodeError as exc:
            self._logger.info(f"discarding corrupt realloc payload: {exc}")
            payload = None
        except OSError as exc:
            # persistent I/O trouble: leave the file for the next round
            self._logger.info(
                f"realloc payload unreadable ({exc}); leaving it staged"
            )
            return None
        if payload is not None:
            # schema validation BEFORE the payload can reach world.json:
            # a malformed realloc.json (hand-edited, version-skewed, or
            # torn by a dying writer) must be rejected with a precise
            # diagnostic here, not crash every relaunched trainer's
            # allocator
            from ..analysis.plan_check import verify_allocation_payload

            problems = verify_allocation_payload(payload)
            if problems:
                self._logger.info(
                    "rejecting malformed realloc payload: "
                    + "; ".join(problems)
                )
                payload = None
        try:
            os.remove(path)
        except OSError:
            pass
        return payload

    # --- world agreement --------------------------------------------------
    def _world_path(self, generation: int) -> str:
        return os.path.join(self.root, f"gen_{generation}", "world.json")

    def form_world(self, generation: int,
                   expect: Optional[int] = None,
                   fallback_allocation: Optional[Dict] = None) -> Dict:
        """Agree on generation ``generation``'s world; returns its spec.

        ``expect``: for the initial formation, wait until that many nodes
        are alive (later generations take whoever is still beating).
        ``fallback_allocation``: embedded as ``spec['allocation']`` when
        no payload is freshly staged — the coordinator re-publishing its
        last known device-speed scales keeps every member (including
        supervisors restarted since the heal) on ONE allocation model
        across crash re-forms.
        Returns ``{"coordinator": addr, "members": [...], "generation": g}``
        with this node guaranteed to be a member (else RuntimeError — the
        cluster moved on without us).
        """
        deadline = time.monotonic() + self.timeout_s
        self.refresh_beacon()
        if expect is not None:
            while len(self.alive_nodes()) < expect:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"only {self.alive_nodes()} of {expect} nodes "
                        f"arrived within {self.timeout_s}s"
                    )
                self.refresh_beacon()
                time.sleep(0.2)
        else:
            # settle: let every survivor notice the failure and beat again
            settle_end = time.monotonic() + self.settle_s
            while time.monotonic() < settle_end:
                self.refresh_beacon()
                time.sleep(0.2)

        members = self.alive_nodes()
        if self.node_id not in members:
            raise RuntimeError(
                f"node {self.node_id} not in membership {members}"
            )
        path = self._world_path(generation)
        if members[0] == self.node_id:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            spec = dict(
                coordinator=f"{_routable_host()}:{_free_port()}",
                members=members,
                generation=generation,
            )
            payload = self.take_payload()
            if payload is None:
                payload = fallback_allocation
            if payload is not None:
                spec["allocation"] = payload
            atomic_write(path, json.dumps(spec),
                         tmp_suffix=f".tmp{self.node_id}")
            return spec
        while True:
            if os.path.exists(path):
                # the publish is atomic locally, but on a networked FS the
                # rename can surface before the data does — a short
                # deterministic retry absorbs that class of transient
                def read_spec():
                    with open(path) as fh:
                        return json.load(fh)

                spec = retry_call(
                    read_spec,
                    retry_on=(OSError, json.JSONDecodeError),
                    attempts=4,
                    # the read's retry budget is whatever is left of THIS
                    # formation round: backing off past the formation
                    # deadline would convert a transient into a timeout
                    deadline_s=max(0.0, deadline - time.monotonic()),
                    logger=self._logger,
                    describe=f"read {path}",
                )
                if self.node_id not in spec["members"]:
                    raise RuntimeError(
                        f"node {self.node_id} excluded from generation "
                        f"{generation}: {spec['members']}"
                    )
                return spec
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no world.json for generation {generation} within "
                    f"{self.timeout_s}s"
                )
            self.refresh_beacon()
            time.sleep(0.2)


class ElasticSupervisor:
    """Per-node trainer babysitter: form -> launch -> watch -> re-form.

    ``trainer_cmd(spec, rank)`` returns the argv for this node's trainer
    given the world spec and this node's rank in it; the supervisor adds
    the ``SKYTPU_*`` world env.  The trainer must exit 0 when training is
    complete; any abnormal exit triggers a re-formation round (up to
    ``max_reforms``), shrinking to whoever still runs a supervisor.

    A trainer exit with :data:`REALLOC_RC` is a PLANNED re-form (the
    self-heal hook wants a new allocation): it spends ``max_reallocs``
    budget instead of ``max_reforms``, and the staged measurement rides
    into the next ``world.json`` as ``spec['allocation']``, exported to
    the relaunched trainer as ``SKYTPU_ALLOCATION``.
    """

    def __init__(
        self,
        node_id: int,
        rendezvous_dir: str,
        trainer_cmd: Callable[[Dict, int], Sequence[str]],
        expect: int,
        max_reforms: int = 3,
        max_reallocs: int = 5,
        env: Optional[Dict[str, str]] = None,
        logger: Optional[Logger] = None,
        stale_s: float = 6.0,
        settle_s: float = 2.0,
        timeout_s: float = 120.0,
    ):
        self.node_id = int(node_id)
        self.rdv = FileRendezvous(rendezvous_dir, node_id, stale_s=stale_s,
                                  settle_s=settle_s, timeout_s=timeout_s,
                                  logger=logger)
        self._trainer_cmd = trainer_cmd
        self._expect = int(expect)
        self._max_reforms = int(max_reforms)
        self._max_reallocs = int(max_reallocs)
        self._env = dict(env) if env is not None else dict(os.environ)
        self._logger = logger or Logger()
        self.generations: List[Dict] = []
        # the latest allocation payload seen in any generation's world
        # spec: a CRASH re-form has no freshly staged payload, but the
        # degraded node is still degraded — dropping the correction would
        # force a whole new realloc cycle just to re-measure it
        self._last_allocation: Optional[Dict] = None

    def _launch(self, spec: Dict) -> subprocess.Popen:
        rank = spec["members"].index(self.node_id)
        env = dict(self._env)
        env["SKYTPU_COORDINATOR"] = spec["coordinator"]
        env["SKYTPU_NUM_PROCESSES"] = str(len(spec["members"]))
        env["SKYTPU_PROCESS_ID"] = str(rank)
        env["SKYTPU_GENERATION"] = str(spec["generation"])
        # where a SelfHealHook in exit mode stages its realloc payload
        env["SKYTPU_RENDEZVOUS"] = self.rdv.root
        # ONLY world.json decides the allocation env: deriving it from
        # per-supervisor memory would let a restarted supervisor launch
        # its trainer with different scales than its peers, and the ranks
        # would solve different partitions.  The coordinator re-embeds
        # its last known allocation on crash re-forms (form_world
        # fallback), so the shared spec stays the single source of truth.
        if spec.get("allocation") is not None:
            # defense in depth: take_payload validates on the coordinator,
            # but a non-coordinator reads world.json as published — if a
            # skewed/older coordinator embedded a malformed allocation,
            # reject it HERE rather than launch a trainer that dies
            # parsing SKYTPU_ALLOCATION after its start-up
            from ..analysis.plan_check import verify_allocation_payload

            problems = verify_allocation_payload(spec["allocation"])
            if problems:
                self._logger.info(
                    f"[node {self.node_id}] ignoring malformed "
                    f"allocation in world.json (gen "
                    f"{spec['generation']}): " + "; ".join(problems)
                )
                env.pop("SKYTPU_ALLOCATION", None)
            else:
                self._last_allocation = spec["allocation"]
                env["SKYTPU_ALLOCATION"] = json.dumps(spec["allocation"])
        else:
            env.pop("SKYTPU_ALLOCATION", None)
        # fast dead-peer detection so a lost node surfaces as a trainer
        # exit within seconds, not the process group's 30-minute default
        env.setdefault(PEER_TIMEOUT_ENV, "10")
        # JAX's supervisor also pins its persistent XLA cache into the
        # trainer; the port has no compile cache to pin: every
        # generation's trainer loads the kernel libraries already built
        # under build/kernels/ (ops/_build.py), which nvcc never rebuilds
        # while their sources are unchanged
        cmd = list(self._trainer_cmd(spec, rank))
        self._logger.info(
            f"[node {self.node_id}] gen {spec['generation']}: rank {rank}/"
            f"{len(spec['members'])} coordinator {spec['coordinator']}"
        )
        return subprocess.Popen(cmd, env=env)

    def run(self) -> int:
        """Supervise until the trainer completes (rc 0) or re-forms are
        exhausted.  Returns the final trainer exit code."""
        generation = 0
        spec = self.rdv.form_world(0, expect=self._expect)
        self.generations.append(spec)
        reforms = 0
        reallocs = 0
        while True:
            proc = self._launch(spec)
            while True:
                try:
                    rc = proc.wait(timeout=1.0)
                    break
                except subprocess.TimeoutExpired:
                    self.rdv.refresh_beacon()
            if rc == 0:
                self._logger.info(
                    f"[node {self.node_id}] trainer complete "
                    f"(generation {spec['generation']})"
                )
                self.rdv.take_payload()  # don't poison a later run
                return 0
            # A peer's planned exit kills THIS node's trainer too (its
            # collectives fail once the peer is gone), with a
            # crash-looking rc.  Two signals re-classify it as planned:
            # the staged payload (until the coordinator consumes it —
            # which can happen seconds before slow peers' trainers die)
            # and the durable per-generation marker the REALLOC_RC
            # observer publishes below, which has no consumption race.
            if rc == REALLOC_RC:
                self.rdv.mark_planned(generation + 1)
            planned = (
                rc == REALLOC_RC
                or self.rdv.has_staged_payload()
                or self.rdv.planned_marked(generation + 1)
            )
            if planned:
                # planned re-form: a trainer snapshotted and asked for a
                # new allocation — membership is unchanged, so this spends
                # its own budget, not the crash-recovery one
                if reallocs >= self._max_reallocs:
                    self._logger.info(
                        f"[node {self.node_id}] giving up after "
                        f"{reallocs} planned re-allocations"
                    )
                    # consume the staged-but-unused payload: left behind
                    # it would classify a LATER run's first crash in this
                    # rendezvous dir as "planned" and feed it stale scales
                    self.rdv.take_payload()
                    return rc
                reallocs += 1
                generation += 1
                self._logger.info(
                    f"[node {self.node_id}] planned re-allocation "
                    f"(rc={rc}, "
                    f"{'own trainer' if rc == REALLOC_RC else 'peer'}); "
                    f"re-forming as generation {generation}"
                )
                spec = self.rdv.form_world(
                    generation, fallback_allocation=self._last_allocation
                )
                self.generations.append(spec)
                continue
            if reforms >= self._max_reforms:
                self._logger.info(
                    f"[node {self.node_id}] giving up after {reforms} "
                    f"re-formations (rc={rc})"
                )
                self.rdv.take_payload()  # don't poison a later run
                return rc
            reforms += 1
            generation += 1
            self._logger.info(
                f"[node {self.node_id}] trainer exited rc={rc} "
                f"(peer failure); re-forming as generation {generation}"
            )
            spec = self.rdv.form_world(
                generation, fallback_allocation=self._last_allocation
            )
            self.generations.append(spec)


__all__ = [
    "ElasticSupervisor",
    "FileRendezvous",
    "HEARTBEAT_ABORT_RC",
    "REALLOC_RC",
]
