"""Node failure domain, chaos acceptance, through both packages: the cases
of tests/test_node_chaos.py on each package's ``MultiNodeStack`` (real
gRPC workers, a health sidecar per node), the same steps and the same
expected outcomes, compared after the rename map (routes ``/add{tpu,gpu}``,
the body's ``{tpus,gpus}PerHost``).

(a) a killed worker: its single lease fences within one suspect→dead
    window, the quota frees, the node answers 503 ``NodeCordoned``, and a
    restarted worker converges its gate and journal with zero resurrected
    grants;
(b) a killed member host of a live slice: repaired onto a spare pod under
    the SAME group lease with one generation bump, or torn down as a unit
    with no spare;
(c) a draining worker: the master cordons it within one fleet tick; a
    slice member migrates grow-first onto a spare, and defers (never tears
    down) without one.

The training-loop case runs the port's member processes
(``torchcheck/federation.py`` on gloo, one CPU device each) against the
port's master: the job re-forms onto the spare and its step counter and
loss continue. The fleet tick is driven by hand (``TPU_FLEET_INTERVAL_S``
pinned huge), and every wait has its own deadline."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _manual_fleet_ticks(monkeypatch):
    monkeypatch.setenv("TPU_FLEET_INTERVAL_S", "3600")
    monkeypatch.delenv("TPU_NODE_HEALTH", raising=False)


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _req(base, path, method="GET", body=None, timeout=60):
    req = urllib.request.Request(base + path, method=method, data=body)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stack(pkg, tmp_path, hosts, n_chips=4, **kw):
    config = pkg.mod("master.admission").BrokerConfig(
        **kw.pop("broker", {}))
    return pkg.mod("testing.sim").MultiNodeStack(
        [pkg.host(tmp_path / pkg.name / f"node{i}") for i in range(hosts)],
        n_chips=n_chips, health=True, broker_config=config, **kw)


def _add(pkg, pod, n, entire, tenant=None):
    query = f"?tenant={tenant}" if tenant else ""
    return (f"/add{pkg.dev}/namespace/default/pod/{pod}/{pkg.dev}/{n}"
            f"/isEntireMount/{'true' if entire else 'false'}{query}")


def _slice(pkg, pods, per_host):
    return json.dumps({
        "pods": [{"namespace": "default", "pod": p} for p in pods],
        f"{pkg.dev}sPerHost": per_host}).encode()


def _tick_until(stack, node, state, ticks=8):
    nh = stack.gateway.nodehealth
    for _ in range(ticks):
        stack.gateway.fleet.tick()
        if nh.state(node) == state:
            return True
    return nh.state(node) == state


def _wait_for(predicate, timeout_s=15.0):
    """Node-down handling (fencing, repair) runs on its own threads off
    the fleet tick — assertions poll for the settled outcome."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _repairs(pkg, group, seq0=0):
    return [e["attrs"]["outcome"]
            for e in pkg.mod("utils.events").EVENTS.tail(300)
            if e["seq"] > seq0 and e["kind"] == "slice_repair"
            and e["attrs"].get("group") == group]


def _seq(pkg):
    tail = pkg.mod("utils.events").EVENTS.tail(1)
    return tail[-1]["seq"] if tail else 0


# -- (a) kill a worker mid-steady-state ----------------------------------------

def _killed_worker(pkg, tmp_path):
    stack = _stack(pkg, tmp_path, 2, gate=True,
                   broker={"quotas": {"team": 4}})
    chaos = pkg.mod("testing.chaos")
    out = {}
    try:
        stack.gateway.fleet.tick()      # the node is observed ALIVE
        out["attach"] = _req(stack.base, _add(pkg, "workload-1", 4, True,
                                              "team"))[0]
        broker = stack.gateway.broker
        out["usage"] = broker.leases.tenant_usage("team")
        st, p = _req(stack.base, _add(pkg, "workload-0", 4, True, "team"))
        out["over_quota"] = (st, p["result"])
        seq0 = _seq(pkg)
        stack.kill_node(1)
        nh = stack.gateway.nodehealth
        out["dead"] = _tick_until(stack, "node-1", "dead")
        out["fenced"] = _wait_for(
            lambda: broker.leases.get("default", "workload-1") is None)
        out["usage_after"] = broker.leases.tenant_usage("team")
        out["fences"] = [e["attrs"]["reason"]
                         for e in pkg.mod("utils.events").EVENTS.tail(200)
                         if e["seq"] > seq0 and e["kind"] == "lease_fenced"
                         and e.get("pod") == "workload-1"]
        out["freed_quota"] = _req(stack.base, _add(
            pkg, "workload-0", 4, True, "team"))[0]
        st, p = _req(stack.base, _add(pkg, "workload-1", 1, False))
        out["cordoned"] = (st, p["result"], p.get("node_state"))
        stack.restart_node(1)
        rig = stack.rigs[1]
        out["granted_after_restart"] = sorted(rig.gate.granted_uuids())
        out["slaves_after_restart"] = len(rig.sim.slave_pods())
        out["backlog"] = rig.service.journal.backlog()
        chaos.assert_node_death_invariants(broker, nh)
        out["recovered"] = _tick_until(stack, "node-1", "healthy")
        out["after_recovery"] = _req(stack.base, _add(
            pkg, "workload-1", 2, False))[0]
        chaos.assert_slice_invariants(broker, [r.sim for r in stack.rigs],
                                      health=nh)
        return out
    finally:
        stack.close()


def test_killed_worker_leases_fence_and_restart_converges(tmp_path):
    outs = [_killed_worker(p, tmp_path) for p in BOTH]
    assert outs[0] == outs[1]
    assert outs[1] == {
        "attach": 200, "usage": 4, "over_quota": (429, "QuotaExceeded"),
        "dead": True, "fenced": True, "usage_after": 0,
        "fences": ["node-dead"], "freed_quota": 200,
        "cordoned": (503, "NodeCordoned", "dead"),
        "granted_after_restart": [], "slaves_after_restart": 0,
        "backlog": 0, "recovered": True, "after_recovery": 200}


# -- (b) slice self-healing ----------------------------------------------------

def _repair(pkg, tmp_path):
    stack = _stack(pkg, tmp_path, 5, gate=True)
    chaos = pkg.mod("testing.chaos")
    try:
        stack.add_workload(4, "spare-0", spare=True)
        stack.gateway.fleet.tick()
        st, p = _req(stack.base, f"/add{pkg.dev}slice", "POST",
                     _slice(pkg, [f"workload-{i}" for i in range(4)], 4))
        assert st == 200, p
        group = p["group"]
        seq0 = _seq(pkg)
        generation = _req(stack.base, "/slicez")[1]["groups"][group][
            "generation"]
        stack.kill_node(2)
        dead = _tick_until(stack, "node-2", "dead")
        bumped = _wait_for(
            lambda: stack.gateway.slices.generation(group) == 2)
        stack.gateway.slices.join_repairs()
        info = _req(stack.base, "/slicez")[1]["groups"].get(group) or {}
        nh = stack.gateway.nodehealth
        chaos.assert_node_death_invariants(stack.gateway.broker, nh)
        chaos.assert_slice_invariants(
            stack.gateway.broker,
            [r.sim for i, r in enumerate(stack.rigs) if i != 2],
            health=nh)
        return {"generation_before": generation, "dead": dead,
                "bumped": bumped,
                "members": sorted(m["pod"] for m in info.get("members",
                                                             [])),
                "generation": info.get("generation"),
                "chips": info.get("chips"),
                "repairs": _repairs(pkg, group, seq0)}
    finally:
        stack.close()


def test_slice_repairs_onto_spare_host_same_group_one_generation_bump(
        tmp_path):
    outs = [_repair(p, tmp_path) for p in BOTH]
    assert outs[0] == outs[1]
    assert outs[1] == {
        "generation_before": 1, "dead": True, "bumped": True,
        "members": ["spare-0", "workload-0", "workload-1", "workload-3"],
        "generation": 2, "chips": 16, "repairs": ["repaired"]}


def _teardown(pkg, tmp_path):
    stack = _stack(pkg, tmp_path, 2)
    try:
        stack.gateway.fleet.tick()
        st, p = _req(stack.base, f"/add{pkg.dev}slice", "POST",
                     _slice(pkg, ["workload-0", "workload-1"], 4))
        assert st == 200, p
        group = p["group"]
        seq0 = _seq(pkg)
        stack.kill_node(1)
        dead = _tick_until(stack, "node-1", "dead")
        broker = stack.gateway.broker
        gone = _wait_for(lambda: broker.leases.groups().get(group) is None)
        stack.gateway.slices.join_repairs()
        pkg.mod("testing.chaos").assert_node_death_invariants(
            broker, stack.gateway.nodehealth)
        return {"dead": dead, "gone": gone,
                "leases": len(broker.leases.leases()),
                "survivor_slaves": len(stack.rigs[0].sim.slave_pods()),
                "repairs": _repairs(pkg, group, seq0)}
    finally:
        stack.close()


def test_slice_with_no_spare_capacity_tears_down_as_a_unit(tmp_path):
    outs = [_teardown(p, tmp_path) for p in BOTH]
    assert outs[0] == outs[1]
    assert outs[1] == {"dead": True, "gone": True, "leases": 0,
                       "survivor_slaves": 0, "repairs": ["torn_down"]}


# -- (c) graceful drain --------------------------------------------------------

def _drain(pkg, tmp_path):
    stack = _stack(pkg, tmp_path, 2)
    try:
        stack.gateway.fleet.tick()
        rig = stack.rigs[1]
        rig.sim.schedule_delay_s = 0.3      # slow the in-flight attach
        results = []
        thread = threading.Thread(target=lambda: results.append(_req(
            stack.base, _add(pkg, "workload-1", 2, False))), daemon=True)
        thread.start()
        time.sleep(0.1)                     # attach is mid-actuation
        rig.drain.begin("test")
        settled = rig.drain.wait_settled(10.0)
        thread.join(timeout=10.0)
        out = {"settled": settled,
               "inflight_attach": results[0][0] if results else None,
               "inflight": rig.drain.status()["inflight"]}
        nh = stack.gateway.nodehealth
        stack.gateway.fleet.tick()          # ONE tick after the flip
        out["state"] = nh.state("node-1")
        st, p = _req(stack.base, _add(pkg, "workload-1", 1, False))
        out["cordoned"] = (st, p["result"])
        out["lease_kept"] = stack.gateway.broker.leases.get(
            "default", "workload-1") is not None
        out["detach"] = _req(
            stack.base, f"/remove{pkg.dev}/namespace/default/pod/"
                        "workload-1/force/false", "POST", b"")[0]
        out["refused"] = rig.drain.status()["refused"]
        return out
    finally:
        stack.close()


def test_drain_settles_inflight_and_master_cordons_within_one_tick(
        tmp_path):
    outs = [_drain(p, tmp_path) for p in BOTH]
    assert outs[0] == outs[1]
    assert outs[1] == {"settled": True, "inflight_attach": 200,
                       "inflight": 0, "state": "draining",
                       "cordoned": (503, "NodeCordoned"),
                       "lease_kept": True, "detach": 200, "refused": 0}


def _migration(pkg, tmp_path, spare):
    stack = _stack(pkg, tmp_path, 3 if spare else 2)
    try:
        seq0 = _seq(pkg)
        if spare:
            stack.add_workload(2, "spare-0", spare=True)
        stack.gateway.fleet.tick()
        st, p = _req(stack.base, f"/add{pkg.dev}slice", "POST",
                     _slice(pkg, ["workload-0", "workload-1"], 4))
        assert st == 200, p
        group = p["group"]
        stack.rigs[1].drain.begin("spot")
        stack.gateway.fleet.tick()
        out = {"state": stack.gateway.nodehealth.state("node-1")}
        # the migration runs on the drain handler's thread: wait for its
        # outcome (migrated, or the deferral's "failed") to be recorded
        out["resolved"] = _wait_for(lambda: _repairs(pkg, group, seq0))
        stack.gateway.slices.join_repairs()
        out["members"] = sorted(
            m.pod for m in stack.gateway.broker.leases.groups().get(
                group, []))
        out["generation"] = stack.gateway.slices.generation(group)
        out["leaver_slaves"] = len(stack.rigs[1].sim.slave_pods())
        out["fenced"] = [e.get("pod")
                         for e in pkg.mod("utils.events").EVENTS.tail(300)
                         if e["seq"] > seq0 and e["kind"] == "lease_fenced"]
        out["repairs"] = _repairs(pkg, group, seq0)
        return out
    finally:
        stack.close()


def test_draining_slice_member_migrates_proactively(tmp_path):
    outs = [_migration(p, tmp_path, spare=True) for p in BOTH]
    assert outs[0] == outs[1]
    assert outs[1] == {"state": "draining", "resolved": True,
                       "members": ["spare-0", "workload-0"],
                       "generation": 2, "leaver_slaves": 0, "fenced": [],
                       "repairs": ["migrated"]}


def test_migration_with_no_spare_defers_and_never_tears_down(tmp_path):
    outs = [_migration(p, tmp_path, spare=False) for p in BOTH]
    assert outs[0] == outs[1]
    assert outs[1] == {"state": "draining", "resolved": True,
                       "members": ["workload-0", "workload-1"],
                       "generation": 1, "leaver_slaves": 1, "fenced": [],
                       "repairs": ["failed"]}


# -- the training loop rides a member host's death -----------------------------

def _spawn_member(base, group, pod, tmp_path, hold_dir):
    status = str(tmp_path / f"{pod}.jsonl")
    argv = [sys.executable, "-m",
            "gpumounter_tpu_torch.torchcheck.federation",
            "--master", base, "--group", group,
            "--member", f"default/{pod}",
            "--checkpoint-root", str(tmp_path / "ckpt"),
            "--local-devices", "1", "--device", "cpu",
            "--status-file", status, "--stop-file", str(tmp_path / "stop"),
            "--barrier-timeout", "6", "--seq-len", "48",
            "--hold-dir", str(hold_dir)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(str(tmp_path / f"{pod}.err"), "wb") as err:
        proc = subprocess.Popen(argv, cwd=REPO, env=env,
                                stdout=subprocess.DEVNULL, stderr=err,
                                start_new_session=True)
    return proc, status


def _records(path):
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except OSError:
        return []


def _steps(path, generation, world):
    return [r for r in _records(path) if r["phase"] == "step"
            and r["generation"] == generation
            and r["world_devices"] == world]


def _reap(procs, timeout_s):
    for proc in procs:
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)


def test_training_loop_survives_member_host_death_via_repair(tmp_path):
    """'Repair the gang, don't restart the job': two port members (one
    CPU device each, gloo) train over a live slice of hosts 0 and 1; host
    1 dies, self-healing re-forms the group onto the spare on host 2
    under the SAME group lease with one generation bump, and the world
    re-forms with the spare's member: step counter and loss trajectory
    continue from the drained state. Each member here is a pod process
    with one gloo rank process (``--local-devices 1``, the hosts' one
    device), and host 1's member is killed once the survivors have left
    their world for the new generation (at the pre-join hold) — a peer
    killed inside a collective would fail it."""
    from gpumounter_tpu_torch.testing.chaos import (
        assert_node_death_invariants, assert_slice_invariants)
    stack = _stack(TORCH, tmp_path, 3, n_chips=1)
    hold = tmp_path / "hold"
    hold.mkdir()
    procs = []
    try:
        stack.add_workload(2, "spare-0", spare=True)
        stack.gateway.fleet.tick()
        st, p = _req(stack.base, "/addgpuslice", "POST",
                     _slice(TORCH, ["workload-0", "workload-1"], 1))
        assert st == 200, p
        group = p["group"]
        m0, s0 = _spawn_member(stack.base, group, "workload-0", tmp_path,
                               hold)
        m1, s1 = _spawn_member(stack.base, group, "workload-1", tmp_path,
                               hold)
        procs = [m0, m1]
        assert _wait_for(lambda: all(
            (hold / f"default--workload-{i}.ready-1").exists()
            for i in (0, 1)), 120)
        (hold / "go-1").touch()
        assert _wait_for(lambda: len(_steps(s0, 1, 2)) >= 3, 120)

        # host 1 dies: suspect, dead, its member fenced, the group
        # repaired onto the spare with ONE generation bump
        stack.kill_node(1)
        assert _tick_until(stack, "node-1", "dead")
        assert _wait_for(
            lambda: stack.gateway.slices.generation(group) == 2)
        stack.gateway.slices.join_repairs()
        info = _req(stack.base, "/slicez")[1]["groups"][group]
        assert sorted(m["pod"] for m in info["members"]) == \
            ["spare-0", "workload-0"]
        assert info["generation"] == 2

        # the survivors drain generation 1 and hold before the join; host
        # 1's member goes with its host, the spare's member starts
        assert _wait_for(lambda: (
            hold / "default--workload-0.ready-2").exists(), 120)
        os.killpg(m1.pid, signal.SIGKILL)
        m1.wait(timeout=10)
        m2, s2 = _spawn_member(stack.base, group, "spare-0", tmp_path, hold)
        procs.append(m2)
        (hold / "go-2").touch()
        assert _wait_for(lambda: len(_steps(s0, 2, 2)) >= 3, 120)

        records = _records(s0)
        steps = [r for r in records if r["phase"] == "step"]
        numbers = [r["step"] for r in steps]
        assert numbers == sorted(set(numbers)), numbers
        done = [r for r in records if r["phase"] == "reshape_done"]
        begin = [r for r in records if r["phase"] == "reshape_begin"]
        assert [r["generation"] for r in done] == [2]
        assert done[0]["rolled_back"] is False
        assert done[0]["fingerprint"] == begin[0]["fingerprint"]
        gen1_last = max(r["step"] for r in steps if r["generation"] == 1)
        assert _steps(s0, 2, 2)[0]["step"] == gen1_last + 1
        started = [r for r in _records(s2) if r["phase"] == "started"][0]
        assert started["resumed"] and started["restored_generation"] == 2
        losses = [r["loss"] for r in steps]
        assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3, losses
        with open(tmp_path / "stop", "w") as f:
            f.write("1")
        _reap([m0, m2], 60)
        assert m0.returncode == 0 and m2.returncode == 0
        nh = stack.gateway.nodehealth
        assert_node_death_invariants(stack.gateway.broker, nh)
        assert_slice_invariants(
            stack.gateway.broker,
            [r.sim for i, r in enumerate(stack.rigs) if i != 1],
            kube=stack.master_kube, health=nh)
    finally:
        _reap(procs, 5)
        stack.close()
