"""The port's worker against the control plane's: the mount service
(attach, detach, policy, busy, force, partial-removal refusal, rollback),
request-id idempotency, the attachment-record cache, the orphan
reconciler, the graceful drain, the parking executor, the resident
actuation agent, and journal replay after a simulated crash. Each scenario
runs through both packages on a fixture tree, device ``i`` of the TPU rig
matched with GPU ``i``; where a scenario ends in a transcript (results,
device roles, slave pods, events), the two packages' transcripts must be
equal after the GPU mapping (``norm_*`` in tests/torch_control_plane.py).
What only GPUs have: every GPU brings the companions the fake node
shares, and they are granted and created once per container."""

import os
import threading
import time

import pytest

from tests.torch_control_plane import (BOTH, IDS, JAX, TORCH, norm_path,
                                       norm_result, norm_text, norm_uuid)

COMPANIONS = {"ctl", "uvm", "uvm-tools"}


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def rig(pkg, tmp_path):
    r = pkg.rig(tmp_path)
    yield r
    r.close()


def _devices(paths) -> list[str]:
    """Device roles of created/removed node paths, companions apart."""
    return [norm_path(p) for p in paths
            if norm_path(p) not in COMPANIONS]


def test_add_single_mount(pkg, rig):
    out = pkg.add(rig.service, "workload", "default", 2, False)
    assert norm_result(out.result) == "SUCCESS" and len(out.chips) == 2
    assert len(rig.sim.slave_pods()) == 2
    assert os.path.exists(os.path.join(rig.cgroup_dir, "devices.allow"))
    created = [c[1] for c in rig.actuator.created]
    assert _devices(created) == ["dev0", "dev1"]
    if pkg is TORCH:         # the shared companions ride once
        assert sorted(norm_path(p) for p in created
                      if norm_path(p) in COMPANIONS) == sorted(COMPANIONS)


@pytest.mark.parametrize("name,n,entire,phase,expect", [
    ("workload", 4, True, None, "SUCCESS"),
    ("ghost", 1, False, None, "POD_NOT_FOUND"),
    ("workload", 1, False, "Pending", "POD_NOT_FOUND"),
    ("workload", 99, False, None, "INSUFFICIENT"),
])
def test_add_outcomes(pkg, rig, name, n, entire, phase, expect):
    if phase:
        rig.sim.kube.set_pod_status("default", "workload", phase=phase)
    out = pkg.add(rig.service, name, "default", n, entire)
    assert norm_result(out.result) == expect
    if expect != "SUCCESS":
        assert rig.sim.slave_pods() == []


def test_add_policy_rejections(pkg, rig):
    errors = pkg.errors
    with pytest.raises(errors.MountPolicyError):
        pkg.add(rig.service, "workload", "default", 0, False)
    assert norm_result(pkg.add(rig.service, "workload", "default", 2,
                               True).result) == "SUCCESS"
    # an entire-mounted pod refuses anything further (ref util.go:207-226)
    for entire in (True, False):
        with pytest.raises(errors.MountPolicyError):
            pkg.add(rig.service, "workload", "default", 1, entire)


def test_remove_subset_unknown_busy_and_force(pkg, rig):
    added = pkg.add(rig.service, "workload", "default", 2, False)
    a, b = added.chips
    out = pkg.remove(rig.service, "workload", "default", ["nope"], False)
    assert norm_result(out.result) == "NOT_FOUND"
    rig.sim.enumerator.busy_pids = {a.device_path: [rig.pid]}
    out = pkg.remove(rig.service, "workload", "default", [a.uuid], False)
    assert (norm_result(out.result), out.busy_pids) == ("BUSY", [rig.pid])
    assert len(rig.sim.slave_pods()) == 2          # nothing deleted
    out = pkg.remove(rig.service, "workload", "default", [a.uuid], True)
    assert norm_result(out.result) == "SUCCESS"
    assert rig.actuator.killed == [(rig.pid, 9)]
    assert len(rig.sim.slave_pods()) == 1
    rig.sim.enumerator.busy_pids = {}
    out = pkg.remove(rig.service, "workload", "default", [], False)
    assert norm_result(out.result) == "SUCCESS"
    assert rig.sim.slave_pods() == []
    assert _devices(p for _pid, p in rig.actuator.removed) == ["dev0",
                                                              "dev1"]


def test_busy_means_the_gpus_own_node(tmp_path):
    """A holder of only the shared companions does not make a GPU busy."""
    rig = TORCH.rig(tmp_path)
    try:
        (gpu,) = rig.service.add_gpu("workload", "default", 1, False).chips
        rig.sim.enumerator.busy_pids = {
            "/dev/nvidiactl": [rig.pid], "/dev/nvidia-uvm": [rig.pid]}
        out = rig.service.remove_gpu("workload", "default", [gpu.uuid],
                                     False)
        assert out.result.name == "SUCCESS" and out.busy_pids == []
    finally:
        rig.close()


def test_remove_partial_entire_mount_refused(pkg, rig):
    added = pkg.add(rig.service, "workload", "default", 4, True)
    out = pkg.remove(rig.service, "workload", "default",
                     [added.chips[0].uuid], False)
    assert norm_result(out.result) == "NOT_FOUND" and "partial" in \
        out.message
    out = pkg.remove(rig.service, "workload", "default",
                     [c.uuid for c in added.chips], False)
    assert norm_result(out.result) == "SUCCESS"


def test_rollback_on_actuation_failure(pkg, rig):
    """A failed actuation deletes the slave pods it allocated and reverts
    what it granted; the error reaches the caller."""
    real = rig.actuator.apply_device_nodes

    def boom(pid, creates=(), removes=(), *args, **kwargs):
        if creates:
            raise pkg.errors.ActuationError("injected mknod failure")
        return real(pid, creates, removes, *args, **kwargs)
    rig.actuator.apply_device_nodes = boom
    with pytest.raises(pkg.errors.ActuationError):
        pkg.add(rig.service, "workload", "default", 2, False)
    assert rig.sim.slave_pods() == []
    assert rig.sim.podresources.assignments == {}
    assert rig.journal.backlog() == 0


def test_metrics_and_one_kubelet_list_per_call(pkg, rig):
    reg = pkg.registry
    before = (reg.attach_latency.count,
              reg.attach_results.value(result="SUCCESS"))
    rig.sim.podresources.list_calls = 0
    assert norm_result(pkg.add(rig.service, "workload", "default", 4,
                               True).result) == "SUCCESS"
    assert rig.sim.podresources.list_calls <= 2
    assert (reg.attach_latency.count,
            reg.attach_results.value(result="SUCCESS")) == (
        before[0] + 1, before[1] + 1)
    rig.sim.podresources.list_calls = 0
    mount_type, chips = pkg.status(rig.service, "workload", "default")
    assert mount_type.value == "entire-mount" and len(chips) == 4
    assert rig.sim.podresources.list_calls <= 2
    rig.sim.podresources.list_calls = 0
    assert norm_result(pkg.remove(rig.service, "workload", "default", [],
                                  False).result) == "SUCCESS"
    assert rig.sim.podresources.list_calls <= 2


def _session(pkg, root) -> dict:
    """One attach/status/detach session, as device roles."""
    rig = pkg.rig(root)
    try:
        added = pkg.add(rig.service, "workload", "default", 2, True,
                        request_id="rid-1")
        mount_type, status = pkg.status(rig.service, "workload", "default")
        slaves = rig.sim.slave_pods()
        nodes = pkg.mod("k8s.objects")
        removed = pkg.remove(rig.service, "workload", "default", [], False)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(rig.sim.kube.events) < 2:
            time.sleep(0.01)
        return {
            "add": norm_result(added.result),
            "devices": [norm_uuid(c.uuid) for c in added.chips],
            "paths": [norm_path(c.container_path) for c in added.chips],
            "status": (mount_type.value,
                       [(norm_uuid(s.device_id), norm_path(s.device_path),
                         bool(s.slave_pod)) for s in status]),
            "slave_labels": sorted(norm_text(f"{k}={v}") for k, v in
                                   nodes.labels(slaves[0]).items()),
            "remove": norm_result(removed.result),
            "events": sorted(norm_text(e["reason"])
                             for e in rig.sim.kube.events),
            "devices_created": _devices(c[1] for c in rig.actuator.created),
        }
    finally:
        rig.close()


def test_sessions_agree_after_the_gpu_mapping(tmp_path):
    jax_run = _session(JAX, tmp_path / "jax")
    torch_run = _session(TORCH, tmp_path / "torch")
    assert jax_run == torch_run
    assert torch_run["events"] == ["<DEV>Attached", "<DEV>Detached"]


# -- idempotency (request ids) ------------------------------------------------

def test_retried_request_adopts_instead_of_double_allocating(pkg, rig):
    first = pkg.add(rig.service, "workload", "default", 2, False,
                    request_id="rid-x")
    again = pkg.add(rig.service, "workload", "default", 2, False,
                    request_id="rid-x")
    assert norm_result(again.result) == "SUCCESS"
    assert sorted(c.uuid for c in again.chips) == sorted(
        c.uuid for c in first.chips)
    assert len(rig.sim.slave_pods()) == 2


def test_concurrent_same_request_is_serialised(pkg, tmp_path):
    rig = pkg.rig(tmp_path, schedule_delay_s=0.1)
    try:
        results = []

        def attach():
            results.append(pkg.add(rig.service, "workload", "default", 2,
                                   False, request_id="rid-c"))
        threads = [threading.Thread(target=attach) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert [norm_result(r.result) for r in results] == ["SUCCESS"] * 2
        assert len(rig.sim.slave_pods()) == 2
    finally:
        rig.close()


def test_resumed_attach_is_recorded_as_resumed(pkg, rig):
    pkg.add(rig.service, "workload", "default", 1, False,
            request_id="rid-r")
    pkg.add(rig.service, "workload", "default", 1, False,
            request_id="rid-r")
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and len(rig.sim.kube.events) < 2:
        time.sleep(0.01)
    assert sorted(norm_text(e["reason"]) for e in rig.sim.kube.events) == [
        "<DEV>AttachResumed", "<DEV>Attached"]


# -- the attachment-record cache ----------------------------------------------

def test_detach_resolves_from_the_attach_record(pkg, tmp_path):
    rig = pkg.rig(tmp_path, informer=True)
    try:
        pkg.add(rig.service, "workload", "default", 4, True,
                request_id="cache")
        before = rig.sim.podresources.list_calls
        assert norm_result(pkg.remove(rig.service, "workload", "default",
                                      [], False).result) == "SUCCESS"
        assert rig.sim.podresources.list_calls == before
        assert ("default", "workload") not in rig.service._attach_records
    finally:
        rig.close()


def test_slave_set_drift_falls_back_to_full_resolution(pkg, tmp_path):
    rig = pkg.rig(tmp_path, informer=True)
    try:
        added = pkg.add(rig.service, "workload", "default", 2, False,
                        request_id="drift")
        # an operator deletes one slave pod behind the worker's back
        victim = rig.sim.slave_pods()[0]["metadata"]["name"]
        rig.sim.kube.delete_pod(rig.sim.settings.pool_namespace, victim)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and \
                rig.informer.get(victim) is not None:
            time.sleep(0.01)
        before = rig.sim.podresources.list_calls
        out = pkg.remove(rig.service, "workload", "default",
                         [c.uuid for c in added.chips], False)
        assert norm_result(out.result) == "NOT_FOUND"   # one is gone
        assert rig.sim.podresources.list_calls > before
    finally:
        rig.close()


# -- the orphan reconciler ----------------------------------------------------

def test_orphans_reclaimed_when_owner_gone(pkg, rig):
    pkg.add(rig.service, "workload", "default", 2, False)
    before = pkg.registry.orphans_reclaimed.value()
    rig.sim.kube.delete_pod("default", "workload")
    reconciler = pkg.mod("worker.reconciler").OrphanReconciler(
        rig.sim.kube, rig.sim.settings)
    assert len(reconciler.scan_once()) == 2
    assert rig.sim.slave_pods() == []
    assert rig.sim.podresources.assignments == {}
    assert pkg.registry.orphans_reclaimed.value() == before + 2


def test_reconciler_keeps_live_owners_and_foreign_pods(pkg, rig):
    pkg.add(rig.service, "workload", "default", 1, True)
    rig.sim.kube.put_pod({"metadata": {
        "name": "stray", "namespace": rig.sim.settings.pool_namespace,
        "labels": {}}, "status": {"phase": "Running"}})
    reconciler = pkg.mod("worker.reconciler").OrphanReconciler(
        rig.sim.kube, rig.sim.settings)
    assert reconciler.scan_once() == []
    assert len(rig.sim.slave_pods()) == 1


def test_recreated_owner_does_not_adopt_stale_slaves(pkg, rig):
    pkg.add(rig.service, "workload", "default", 1, False)
    pod = rig.sim.kube.get_pod("default", "workload")
    pod["metadata"]["uid"] = "uid-recreated"
    rig.sim.kube.put_pod(pod)
    deleted = pkg.mod("worker.reconciler").OrphanReconciler(
        rig.sim.kube, rig.sim.settings).scan_once()
    assert len(deleted) == 1


# -- graceful drain -----------------------------------------------------------

def test_drain_refuses_attaches_and_admits_detaches(pkg, rig):
    drain = pkg.mod("worker.drain").DrainController("node-a")
    rig.service.drain = drain
    added = pkg.add(rig.service, "workload", "default", 1, False)
    assert drain.begin("test")
    with pytest.raises(pkg.errors.WorkerDrainingError):
        pkg.add(rig.service, "workload", "default", 1, False)
    out = pkg.remove(rig.service, "workload", "default",
                     [added.chips[0].uuid], False)
    assert norm_result(out.result) == "SUCCESS"
    status = drain.status()
    assert (status["draining"], status["refused"], status["inflight"]) == (
        True, 1, 0)


def test_drain_waits_for_inflight_actuation(pkg):
    drain = pkg.mod("worker.drain").DrainController("unit-node")
    release, entered = threading.Event(), threading.Event()

    def slow():
        with drain.inflight("attach"):
            entered.set()
            release.wait(5.0)
    t = threading.Thread(target=slow, daemon=True)
    t.start()
    assert entered.wait(2.0)
    drain.begin("test")
    assert drain.wait_settled(0.05) is False
    release.set()
    assert drain.wait_settled(2.0) is True
    t.join(timeout=2.0)


def test_spot_notice_starts_the_drain(pkg, tmp_path):
    drain_mod = pkg.mod("worker.drain")
    notice = tmp_path / "notice"
    fired = threading.Event()
    watcher = drain_mod.SpotTerminationWatcher(
        str(notice), on_terminate=fired.set, poll_interval_s=0.02).start()
    try:
        assert not fired.wait(0.1)
        notice.write_text("preempted")
        assert fired.wait(5.0)
    finally:
        watcher.stop()


# -- the parking executor under the gRPC server -------------------------------

def test_parking_server_runs_more_slow_attaches_than_workers(pkg, tmp_path):
    """Two active threads serve four attaches that wait on a slow
    scheduler: each wait is parked, so all four are in flight at once."""
    rig = pkg.rig(tmp_path, n_chips=4, schedule_delay_s=0.4)
    grpc_mod = pkg.mod("worker.grpc_server")
    server, port = grpc_mod.build_server(rig.service, port=0,
                                         address="127.0.0.1", max_workers=2,
                                         mode="parking", max_parked=16)
    server.start()
    pods = [f"w{i}" for i in range(4)]
    for name in pods:
        rig.sim.add_target_pod(name=name, uid=f"uid-{name}")
        rig.provision_container(rig.sim.kube.get_pod("default", name))
    client = grpc_mod.WorkerClient(f"127.0.0.1:{port}")
    results = []
    try:
        def attach(name):
            results.append(getattr(client, f"add_{pkg.dev}")(
                name, "default", 1, False).result)
        t0 = time.monotonic()
        threads = [threading.Thread(target=attach, args=(p,)) for p in pods]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        elapsed = time.monotonic() - t0
        assert results == [0, 0, 0, 0]
        assert server.parking_executor is not None
        # serialised two at a time they would take >= 2 x 0.4 s x 2
        assert elapsed < 1.6
    finally:
        client.close()
        server.stop(grace=0).wait()
        rig.close()


# -- the resident actuation agent ---------------------------------------------

def test_agent_attach_detach_cycle_without_fallback(pkg, tmp_path):
    rig = pkg.rig(tmp_path, actuator="procroot", informer=True, agent=True,
                  gate=True)
    agent_mod = pkg.mod("actuation.agent")
    before = agent_mod._fallback_total()
    try:
        for i in range(3):
            added = pkg.add(rig.service, "workload", "default", 2, False,
                            request_id=f"cycle-{i}")
            assert norm_result(added.result) == "SUCCESS"
            dev = os.path.join(rig.host.proc_root, str(rig.pid), "root",
                               "dev")
            names = {norm_path(n) for n in os.listdir(dev)
                     if not n.endswith(".majmin")}
            assert {"dev0", "dev1"} <= names
            assert norm_result(pkg.remove(rig.service, "workload",
                                          "default", [], False).result) \
                == "SUCCESS"
        assert agent_mod._fallback_total() == before
        status = rig.agent.status()
        assert status["mode"] == "procroot" and status["executor_alive"]
        assert len(status["ns_fds"]) == 1
    finally:
        rig.close()


def test_agent_fault_falls_back_and_is_counted(pkg, tmp_path):
    agent_mod = pkg.mod("actuation.agent")
    host = pkg.host(tmp_path)
    agent = agent_mod.ResidentActuationAgent(host, fake_nodes=True)
    fallback = pkg.mod("actuation.nsenter").RecordingActuator()
    actuator = agent_mod.AgentActuator(agent, fallback)
    before = pkg.registry.agent_fallbacks.value(reason="open_ns_fd")
    try:
        assert actuator.apply_device_nodes(
            9999, [("/dev/nvidia0", 195, 0)], []) == 1
        assert fallback.created == [(9999, "/dev/nvidia0", 195, 0)]
        assert pkg.registry.agent_fallbacks.value(reason="open_ns_fd") \
            == before + 1
    finally:
        agent.stop()


def test_agent_crash_mid_batch_fallback_completes_the_attach(pkg,
                                                            tmp_path):
    rig = pkg.rig(tmp_path, actuator="procroot", informer=True, agent=True)
    calls = {"n": 0}

    def die_once(op, pid, path):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected agent crash mid-batch")
    rig.agent._op_hook = die_once
    try:
        out = pkg.add(rig.service, "workload", "default", 2, False,
                      request_id="agent-crash")
        assert norm_result(out.result) == "SUCCESS" and calls["n"] >= 2
        assert rig.journal.backlog() == 0
    finally:
        rig.close()


# -- crash and journal replay -------------------------------------------------

def _crashed_attach(pkg, rig, point: str):
    """An attach whose worker dies at ``point``: before actuation (intent
    journaled, slave pods reserved, nothing granted) or after it (no
    commit record)."""
    class Crash(Exception):
        pass
    mounter = rig.service.mounter
    real = mounter.mount_chips

    def mount(pod, chips, all_after):
        if point == "before_actuate":
            raise Crash()
        real(pod, chips, all_after)
        raise Crash()
    mounter.mount_chips = mount
    commit = rig.journal.commit
    rig.journal.commit = lambda jid: None
    with pytest.raises(Crash):
        pkg.add(rig.service, "workload", "default", 2, False,
                request_id=f"crash-{point}")
    mounter.mount_chips = real
    rig.journal.commit = commit


def _restart(pkg, rig):
    """A new worker process over the same journal file and cluster."""
    journal = pkg.mod("worker.journal").AttachJournal(rig.journal.path)
    return pkg.Service(rig.allocator, rig.mounter, rig.sim.kube,
                       rig.sim.settings, journal=journal)


@pytest.mark.parametrize("point", ["before_actuate", "before_commit"])
def test_journal_replay_completes_a_crashed_attach(pkg, tmp_path, point):
    rig = pkg.rig(tmp_path, actuator="procroot", gate=True)
    try:
        _crashed_attach(pkg, rig, point)
        assert rig.journal.backlog() == 1
        service = _restart(pkg, rig)
        outcomes = service.replay_journal()
        assert outcomes.get("completed") == 1, outcomes
        assert service.journal.backlog() == 0
        dev = os.path.join(rig.host.proc_root, str(rig.pid), "root", "dev")
        assert {"dev0", "dev1"} <= {norm_path(n) for n in os.listdir(dev)}
        assert rig.gate.granted_uuids() == {
            c.uuid for c in rig.sim.collector.chips if c.pod_name}
    finally:
        rig.close()


def test_journal_replay_reverts_when_the_owner_died(pkg, tmp_path):
    rig = pkg.rig(tmp_path, actuator="procroot", gate=True)
    try:
        _crashed_attach(pkg, rig, "before_commit")
        rig.sim.kube.delete_pod("default", "workload")
        service = _restart(pkg, rig)
        outcomes = service.replay_journal()
        assert outcomes.get("reverted") == 1, outcomes
        assert rig.sim.slave_pods() == []
        assert service.journal.backlog() == 0
    finally:
        rig.close()


def test_settings_from_env_match_the_control_planes():
    """The same environment gives the same settings in both packages, but
    for the fields that name the device (resource, pool namespace, the
    worker's label selector)."""
    import dataclasses
    env = {"NODE_NAME": "n1", "TPU_GATE": "legacy", "TPU_INFORMER": "0",
           "TPU_AGENT": "0", "TPU_ENUM_CACHE_TTL_S": "2.5",
           "TPU_GRPC_WORKERS": "4", "TPU_GRPC_ASYNC": "0",
           "TPU_JOURNAL_PATH": "", "TPU_USAGE": "0",
           "TPU_WARM_POOL": "entire:2=1", "CGROUP_DRIVER": "cgroupfs"}
    got = [dataclasses.asdict(p.mod("utils.config").Settings.from_env(env))
           for p in BOTH]
    for g in got:
        g.pop("host")
    assert (got[0].pop("resource_name"), got[1].pop("resource_name")) == (
        "google.com/tpu", "nvidia.com/gpu")
    assert (got[0].pop("pool_namespace"), got[1].pop("pool_namespace")) \
        == ("tpu-pool", "gpu-pool")
    assert (got[0].pop("worker_label_selector"),
            got[1].pop("worker_label_selector")) == (
        "app=tpu-mounter-worker", "app=gpu-mounter-worker")
    assert got[0] == got[1]
    assert (got[1]["gate_mode"], got[1]["enum_cache_ttl_s"]) == ("legacy",
                                                                 2.5)
    with pytest.raises(ValueError):
        TORCH.mod("utils.config").Settings.from_env({"TPU_GATE": "maybe"})


def test_build_gate_reads_its_mode_and_node_from_settings(tmp_path):
    gate_mod = TORCH.mod("actuation.gate")
    config = TORCH.mod("utils.config")
    ctrl = TORCH.mod("actuation.cgroup").CgroupDeviceController(
        TORCH.host(tmp_path), driver="cgroupfs", version=1)
    env = {"NODE_NAME": "gpu-node-7"}
    gate = gate_mod.build_gate(config.Settings.from_env(env), ctrl)
    assert (gate.live, gate.node_name) == (True, "gpu-node-7")
    legacy = gate_mod.build_gate(
        config.Settings.from_env({**env, "TPU_GATE": "0"}), ctrl)
    assert not legacy.live


def test_replay_outcomes_agree(tmp_path):
    """The same crash replays to the same outcome in both packages."""
    runs = []
    for pkg in BOTH:
        rig = pkg.rig(tmp_path / pkg.name, actuator="procroot", gate=True)
        try:
            _crashed_attach(pkg, rig, "before_actuate")
            runs.append(_restart(pkg, rig).replay_journal())
        finally:
            rig.close()
    assert runs[0] == runs[1]
