"""The port's elastic re-formation (``parallel/elastic.py``) against the
contracts of ``tests/test_elastic.py`` (the rendezvous cases) and
``tests/test_elastic_reform.py`` (a supervised crash re-form and a
planned ``REALLOC_RC`` re-form, with trainers written in torch over a
gloo world on the CPU); ``verify_allocation_payload`` against the JAX
package's over a corpus of payloads; a port ``FileRendezvous`` and a JAX
one reading each other's files on one directory; and every rendezvous
write synced before its rename (fault C9's rule)."""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from skycomputing_tpu.analysis.plan_check import (
    verify_allocation_payload as jax_verify,
)
from skycomputing_tpu.parallel import elastic as jelastic
from skycomputing_tpu_torch.analysis import verify_allocation_payload
from skycomputing_tpu_torch.parallel import (
    HEARTBEAT_ABORT_RC,
    REALLOC_RC,
    ElasticSupervisor,
    FileRendezvous,
)

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------- file rendezvous
def test_alive_nodes_skips_stray_files(tmp_path):
    """A junk '*.alive' file in the shared rendezvous dir must be skipped
    with a log, not crash every supervisor's membership scan."""
    rdv = FileRendezvous(str(tmp_path), node_id=0)
    rdv.refresh_beacon()
    ndir = tmp_path / "nodes"
    (ndir / "editor-backup.alive").write_text("junk")
    (ndir / ".alive").write_text("junk")
    (ndir / "7.alive").write_text("beacon")
    assert rdv.alive_nodes() == [0, 7]
    assert rdv._warned_strays == {"editor-backup.alive", ".alive"}


def test_realloc_payload_stage_and_consume(tmp_path):
    """stage_payload -> the next coordinator's form_world embeds it as
    spec['allocation'] and consumes the staged file."""
    rdv = FileRendezvous(str(tmp_path), node_id=0, settle_s=0.0,
                         timeout_s=10.0)
    rdv.stage_payload({"device_scale": {"2": 3.0}, "iter": 17})
    assert rdv.has_staged_payload()
    spec = rdv.form_world(1)
    assert spec["allocation"]["device_scale"]["2"] == 3.0
    assert spec["allocation"]["iter"] == 17
    assert not (tmp_path / "realloc.json").exists()  # consumed

    # next generation has no staged payload -> no allocation key
    spec2 = rdv.form_world(2)
    assert "allocation" not in spec2

    # a crash re-form re-embeds the coordinator's last known allocation
    spec3 = rdv.form_world(3, fallback_allocation=spec["allocation"])
    assert spec3["allocation"]["device_scale"]["2"] == 3.0

    # planned-reform markers persist (no consumption race)
    assert not rdv.planned_marked(4)
    rdv.mark_planned(4)
    assert rdv.planned_marked(4)


def test_unreadable_payload_is_discarded(tmp_path):
    rdv = FileRendezvous(str(tmp_path), node_id=0, settle_s=0.0,
                         timeout_s=10.0)
    (tmp_path / "realloc.json").write_text("{not json")
    spec = rdv.form_world(1)
    assert "allocation" not in spec
    assert not (tmp_path / "realloc.json").exists()


def test_malformed_payload_is_rejected_before_world_json(tmp_path):
    rdv = FileRendezvous(str(tmp_path), node_id=0, settle_s=0.0,
                         timeout_s=10.0)
    rdv.stage_payload({"device_scale": {"0": -1.0}})
    spec = rdv.form_world(1)
    assert "allocation" not in spec
    assert not rdv.has_staged_payload()


# ----------------------------------------------- the payload schema, both ways
PAYLOADS = {
    "valid_minimal": {"device_scale": {"0": 2.0}},
    "valid_full": {"device_scale": {"0": 3.0, "1": 1.0},
                   "measured_stage_times": [0.3, 0.1, 0.1],
                   "epoch": 0, "iter": 9},
    "valid_serving_slot": {"device_scale": {"0": 1.0},
                           "serving": {"slots": 4, "max_len": 64}},
    "missing_device_scale": {"iter": 3},
    "not_an_object": [1.0, 2.0],
    "device_scale_a_list": {"device_scale": [2.0]},
    "bool_scale": {"device_scale": {"0": True}},
    "nan_scale": {"device_scale": {"0": math.nan}},
    "inf_scale": {"device_scale": {"0": math.inf}},
    "negative_scale": {"device_scale": {"0": -2.0}},
    "huge_int_scale": {"device_scale": {"0": 10 ** 400}},
    "non_int_key": {"device_scale": {"node-a": 2.0}},
    "bad_iter": {"device_scale": {"0": 2.0}, "iter": -1, "epoch": "0"},
    "bool_iter": {"device_scale": {"0": 2.0}, "iter": True},
    "bad_stage_times": {"device_scale": {"0": 2.0},
                        "measured_stage_times": [0.1, 0.0, "x"]},
    "stage_times_not_list": {"device_scale": {"0": 2.0},
                             "measured_stage_times": 0.5},
    "bad_mesh": {"device_scale": {"0": 2.0},
                 "mesh": {"chips_per_stage": [], "num_devices": 0}},
    "bad_paged_serving": {"device_scale": {"0": 2.0},
                          "serving": {"num_pages": 4, "page_size": 0,
                                      "max_pages_per_request": 8}},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_verify_allocation_payload_matches_the_reference(name):
    payload = PAYLOADS[name]
    problems = verify_allocation_payload(payload)
    assert problems == jax_verify(payload)
    assert (not problems) == name.startswith("valid")


# ------------------------------------------ one directory, both packages
def test_rendezvous_files_are_read_across_packages(tmp_path):
    root = str(tmp_path)
    port = {i: FileRendezvous(root, i, settle_s=0.0, timeout_s=10.0)
            for i in (0, 1)}
    jax = {i: jelastic.FileRendezvous(root, i, settle_s=0.0, timeout_s=10.0)
           for i in (0, 1)}
    port[0].refresh_beacon()
    jax[1].refresh_beacon()
    assert port[0].alive_nodes() == jax[1].alive_nodes() == [0, 1]
    (tmp_path / "nodes" / "junk.alive").write_text("x")
    assert port[1].alive_nodes() == jax[0].alive_nodes() == [0, 1]

    # JAX stages, the port's coordinator publishes, JAX reads the world
    payload = {"device_scale": {"0": 2.5}, "epoch": 0, "iter": 6}
    jax[1].stage_payload(payload)
    spec = port[0].form_world(1)
    assert spec["allocation"] == payload and spec["members"] == [0, 1]
    assert jax[1].form_world(1) == spec
    # the port stages, JAX's coordinator publishes, the port reads it
    port[1].stage_payload(payload)
    jspec = jax[0].form_world(2)
    assert jspec["allocation"] == payload
    assert port[1].form_world(2) == jspec
    # planned markers, both ways
    jax[0].mark_planned(3)
    port[1].mark_planned(4)
    assert port[0].planned_marked(3) and jax[1].planned_marked(4)
    # byte layout: the same files under the same names
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "gen_1", "gen_2", "nodes", "planned_gen_3.json",
        "planned_gen_4.json"]


def test_rendezvous_writes_sync_before_rename(tmp_path, monkeypatch):
    """Every file the rendezvous publishes is fsync'ed as the temporary
    file it is renamed from (``utils.atomic_write``, fault C9)."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        events.append(("fsync", os.fstat(fd).st_ino))
        return real_fsync(fd)

    def replace(src, dst, *args, **kwargs):
        events.append(("replace", os.stat(src).st_ino, os.path.basename(dst)))
        return real_replace(src, dst, *args, **kwargs)

    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "replace", replace)
    rdv = FileRendezvous(str(tmp_path), node_id=0, settle_s=0.0,
                         timeout_s=10.0)
    rdv.stage_payload({"device_scale": {"0": 2.0}})
    rdv.mark_planned(1)
    rdv.form_world(1)
    monkeypatch.undo()
    renames = [(i, e) for i, e in enumerate(events) if e[0] == "replace"]
    assert [e[2] for _, e in renames] == [
        "realloc.json", "planned_gen_1.json", "world.json"]
    for i, (_, ino, _name) in renames:
        assert i > 0 and events[i - 1] == ("fsync", ino)


def test_supervisor_drops_a_malformed_world_allocation(tmp_path):
    """A non-coordinator reads world.json as published: a malformed
    allocation there is ignored, not exported to the trainer."""
    out = tmp_path / "env.json"
    probe = ("import json, os, sys; json.dump({k: v for k, v in "
             "os.environ.items() if k.startswith('SKYTPU_')}, "
             "open(sys.argv[1], 'w'))")
    sup = ElasticSupervisor(
        0, str(tmp_path / "rdv"),
        trainer_cmd=lambda spec, rank: [sys.executable, "-c", probe,
                                        str(out)],
        expect=1, env={"PATH": os.environ.get("PATH", "")})
    for allocation, exported in (({"device_scale": {"0": 0.0}}, None),
                                 ({"device_scale": {"0": 2.0}},
                                  {"device_scale": {"0": 2.0}})):
        spec = dict(coordinator="127.0.0.1:1", members=[0], generation=3,
                    allocation=allocation)
        assert sup._launch(spec).wait(timeout=60) == 0
        env = json.loads(out.read_text())
        assert env["SKYTPU_PROCESS_ID"] == "0"
        assert env["SKYTPU_GENERATION"] == "3"
        assert env["SKYTPU_PEER_TIMEOUT_S"] == "10"
        got = env.get("SKYTPU_ALLOCATION")
        assert (json.loads(got) if got else None) == exported


# ------------------------------------------------- supervised re-formation
_TRAINER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from skycomputing_tpu_torch.parallel import initialize_from_env
    from skycomputing_tpu_torch.utils import atomic_torch_save

    work = sys.argv[1]
    node_id = int(os.environ["ELASTIC_NODE_ID"])
    gen = int(os.environ["SKYTPU_GENERATION"])
    assert initialize_from_env(device="cpu") is True
    rank, world = dist.get_rank(), dist.get_world_size()

    TOTAL_ITERS = 8
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    rows = slice(rank * 8 // world, (rank + 1) * 8 // world)  # dp shard

    ckpt = os.path.join(work, "ckpt.pt")
    if os.path.exists(ckpt):
        blob = torch.load(ckpt)
        W, start = blob["W"], int(blob["it"])
    else:
        W, start = torch.zeros(16, 4), 0

    for it in range(start, TOTAL_ITERS):
        # the mean squared error over the whole batch: each rank's shard
        # sums, one all-reduce adds them
        err = X[rows] @ W - y[rows]
        buf = torch.cat([(2.0 / 32) * (X[rows].T @ err).reshape(-1),
                         ((err ** 2).sum() / 32).reshape(1)])
        dist.all_reduce(buf)
        W = W - 0.02 * buf[:-1].reshape(16, 4)
        if rank == 0:
            with open(os.path.join(work, "losses.log"), "a") as fh:
                fh.write(f"{gen} {it} {float(buf[-1]):.8f}\\n")
            atomic_torch_save({"W": W, "it": it + 1}, ckpt)
        # node 1 is "lost" here: trainer dies, supervisor follows
        if node_id == 1 and gen == 0 and it == 2:
            os._exit(3)
    print(f"TRAINER_DONE node={node_id} gen={gen}", flush=True)
    """
)

_SUPERVISOR = textwrap.dedent(
    """
    import json, os, sys
    from skycomputing_tpu_torch.parallel import ElasticSupervisor

    node_id = int(sys.argv[1]); rdv = sys.argv[2]
    trainer = sys.argv[3]; work = sys.argv[4]
    max_reforms = int(sys.argv[5])

    env = dict(os.environ)
    env["ELASTIC_NODE_ID"] = str(node_id)

    # gloo reports the lost peer at once, so the lost node's beacon must
    # be stale (3 s) by the end of the survivor's settle (4 s)
    sup = ElasticSupervisor(
        node_id, rdv,
        trainer_cmd=lambda spec, rank: [sys.executable, trainer, work],
        expect=2, max_reforms=max_reforms, env=env,
        stale_s=3.0, settle_s=4.0, timeout_s=60.0,
    )
    rc = sup.run()
    print("GENERATIONS " + json.dumps(
        [s["members"] for s in sup.generations]), flush=True)
    sys.exit(0 if rc == 0 else 1)
    """
)


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _supervise(argvs, timeout=90.0):
    procs = [subprocess.Popen([sys.executable, *argv], env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _generations(out):
    return json.loads(out.split("GENERATIONS ", 1)[1].splitlines()[0])


def test_node_loss_reforms_and_resumes(tmp_path):
    work = tmp_path / "work"
    work.mkdir()
    trainer = tmp_path / "trainer.py"
    supervisor = tmp_path / "supervisor.py"
    trainer.write_text(_TRAINER)
    supervisor.write_text(_SUPERVISOR)

    (rc0, out0), (rc1, out1) = _supervise(
        [[str(supervisor), str(node_id), str(tmp_path / "rdv"), str(trainer),
          str(work), str(max_reforms)]
         for node_id, max_reforms in ((0, 3), (1, 0))])
    assert rc0 == 0, f"survivor supervisor failed rc={rc0}\n{out0[-3000:]}"
    assert rc1 != 0, "lost node's supervisor must report failure"

    # the survivor went through exactly two generations: [0,1] then [0]
    gens = _generations(out0)
    assert gens[0] == [0, 1] and gens[-1] == [0], gens

    # loss log: continuous iters across the generation boundary, falling
    rows = [ln.split() for ln in
            (work / "losses.log").read_text().splitlines()]
    by_iter = {int(it): (int(g), float(l)) for g, it, l in rows}
    assert len(rows) == 8 and sorted(by_iter) == list(range(8)), rows
    assert {g for g, _ in by_iter.values()} == {0, 1}
    losses = [by_iter[i][1] for i in range(8)]
    assert losses[-1] < losses[3] < losses[0], losses
    # the resumed trajectory CONTINUES: every post-reform loss is below
    # the last pre-crash loss
    crash_gen = [l for g, l in by_iter.values() if g == 0]
    resumed = [l for g, l in by_iter.values() if g == 1]
    assert max(resumed) < min(crash_gen)


_REALLOC_TRAINER = textwrap.dedent(
    """
    import json, os, sys
    import torch

    from skycomputing_tpu_torch.parallel import REALLOC_RC, FileRendezvous
    from skycomputing_tpu_torch.utils import atomic_torch_save

    work = sys.argv[1]
    gen = int(os.environ["SKYTPU_GENERATION"])
    rank = int(os.environ["SKYTPU_PROCESS_ID"])
    rdv_dir = os.environ["SKYTPU_RENDEZVOUS"]  # exported by the supervisor

    TOTAL_ITERS = 8
    ckpt = os.path.join(work, "ckpt.pt")
    if os.path.exists(ckpt):
        blob = torch.load(ckpt)
        W, start = blob["W"], int(blob["it"])
    else:
        W, start = torch.zeros(4), 0

    if gen >= 1:
        # the re-formed world must carry the staged measurement
        alloc = json.loads(os.environ["SKYTPU_ALLOCATION"])
        with open(os.path.join(work, "carried_allocation.json"), "w") as fh:
            json.dump(dict(alloc, resumed_at=start, gen=gen,
                           peer_timeout=os.environ["SKYTPU_PEER_TIMEOUT_S"]),
                      fh)

    for it in range(start, TOTAL_ITERS):
        W = W + 1.0  # a 'step' whose effect the resume must not repeat
        with open(os.path.join(work, "iters.log"), "a") as fh:
            fh.write(f"{gen} {it} {float(W[0]):.1f}\\n")
        atomic_torch_save({"W": W, "it": it + 1}, ckpt)
        if gen == 0 and it == 3:
            # self-heal exit: snapshot is on disk, stage the measured
            # device scales, ask the supervisor for a planned re-form
            FileRendezvous(rdv_dir, rank).stage_payload(
                {"device_scale": {"2": 3.0}, "iter": it}
            )
            sys.exit(REALLOC_RC)
    print(f"TRAINER_DONE gen={gen}", flush=True)
    """
)

_REALLOC_SUPERVISOR = textwrap.dedent(
    """
    import json, os, sys
    from skycomputing_tpu_torch.parallel import ElasticSupervisor

    node_id = int(sys.argv[1]); rdv = sys.argv[2]
    trainer = sys.argv[3]; work = sys.argv[4]

    sup = ElasticSupervisor(
        node_id, rdv,
        trainer_cmd=lambda spec, rank: [sys.executable, trainer, work],
        expect=1,
        max_reforms=0,   # NO crash budget: a planned re-form must not spend it
        max_reallocs=2,
        stale_s=6.0, settle_s=0.5, timeout_s=60.0,
    )
    rc = sup.run()
    print("GENERATIONS " + json.dumps(
        [s["members"] for s in sup.generations]), flush=True)
    sys.exit(rc)
    """
)


def test_realloc_rc_reforms_and_resumes_at_saved_iter(tmp_path):
    """A trainer exiting REALLOC_RC (the SelfHealHook's planned re-form)
    is relaunched in a new generation that resumes at the saved iter and
    sees the staged allocation through world.json — and with
    ``max_reforms=0`` the planned exit provably does not spend the
    crash-recovery budget."""
    assert (REALLOC_RC, HEARTBEAT_ABORT_RC) == (
        jelastic.REALLOC_RC, jelastic.HEARTBEAT_ABORT_RC)
    work = tmp_path / "work"
    work.mkdir()
    trainer = tmp_path / "trainer.py"
    supervisor = tmp_path / "supervisor.py"
    trainer.write_text(_REALLOC_TRAINER)
    supervisor.write_text(_REALLOC_SUPERVISOR)

    ((rc, out),) = _supervise([[str(supervisor), "0", str(tmp_path / "rdv"),
                                str(trainer), str(work)]])
    assert rc == 0, out[-3000:]

    # two generations, same single-node membership
    assert _generations(out) == [[0], [0]]
    # the planned re-form's durable marker
    assert (tmp_path / "rdv" / "planned_gen_1.json").exists()

    # iteration log: continuous across the planned re-form, no replay
    rows = [ln.split() for ln in (work / "iters.log").read_text().splitlines()]
    assert [(int(g), int(it)) for g, it, _ in rows] == (
        [(0, i) for i in range(4)] + [(1, i) for i in range(4, 8)]
    )
    # W incremented exactly once per iter across the boundary
    assert [float(w) for _, _, w in rows] == [float(i + 1) for i in range(8)]

    # the staged measurement rode through world.json into the relaunch
    carried = json.loads((work / "carried_allocation.json").read_text())
    assert carried["device_scale"]["2"] == 3.0
    assert carried["resumed_at"] == 4 and carried["gen"] == 1
    assert carried["peer_timeout"] == "10"
