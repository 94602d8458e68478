"""Orphan reconciliation and recovery after a worker restart, through both
packages: the cases of tests/test_reconciler.py that
tests/test_torch_worker.py does not hold. State is derived from the
cluster (the kubelet's listing and the slave pods' labels), never from the
worker's memory."""

import time

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_result


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def rig(pkg, tmp_path):
    r = pkg.rig(tmp_path)
    yield r
    r.close()


def _reconciler(pkg, rig, **kwargs):
    return pkg.mod("worker.reconciler").OrphanReconciler(
        rig.sim.kube, rig.sim.settings, **kwargs)


def test_orphan_deleted_when_owner_terminal(pkg, rig):
    pkg.add(rig.service, "workload", "default", 1, True)
    rig.sim.kube.set_pod_status("default", "workload", phase="Succeeded")
    assert len(_reconciler(pkg, rig).scan_once()) == 1
    assert rig.sim.slave_pods() == []


def test_other_nodes_slaves_untouched(pkg, rig):
    pkg.add(rig.service, "workload", "default", 1, False)
    rig.sim.kube.delete_pod("default", "workload")
    rig.sim.settings.node_name = "node-elsewhere"
    reconciler = _reconciler(pkg, rig)
    assert reconciler.scan_once() == []
    assert len(rig.sim.slave_pods()) == 1
    rig.sim.settings.node_name = "node-a"      # the node's own worker
    assert len(reconciler.scan_once()) == 1


def test_unlabelled_pool_pods_left_alone(pkg, rig):
    consts = pkg.consts
    rig.sim.kube.put_pod({
        "metadata": {"name": "hand-made",
                     "namespace": rig.sim.settings.pool_namespace,
                     "labels": {consts.SLAVE_POD_LABEL_KEY:
                                consts.SLAVE_POD_LABEL_VALUE}},
        "spec": {}, "status": {"phase": "Running"}})
    assert _reconciler(pkg, rig).scan_once() == []


def test_background_loop_runs(pkg, rig):
    pkg.add(rig.service, "workload", "default", 1, False)
    rig.sim.kube.delete_pod("default", "workload")
    reconciler = _reconciler(pkg, rig, interval_s=0.05).start()
    try:
        deadline = time.time() + 3
        while time.time() < deadline and rig.sim.slave_pods():
            time.sleep(0.02)
        assert rig.sim.slave_pods() == []
    finally:
        reconciler.stop()


def test_recreated_owner_reclaims_and_mounts_fresh(pkg, rig):
    """The StatefulSet pattern: the owner comes back under its name with a
    new UID; the old slaves are orphans and the new pod mounts afresh."""
    pkg.add(rig.service, "workload", "default", 1, False)
    rig.sim.kube.delete_pod("default", "workload")
    reborn = pkg.mod("testing.sim").make_target_pod(uid="uid-reborn")
    rig.sim.kube.put_pod(reborn)
    rig.provision_container(reborn)
    assert len(_reconciler(pkg, rig).scan_once()) == 1
    assert rig.sim.slave_pods() == []
    assert norm_result(pkg.add(rig.service, "workload", "default", 1,
                               True).result) == "SUCCESS"


def _namespaces(pkg, rig) -> list:
    """default/workload and team-b/workload on one node, kept apart."""
    team_b = rig.sim.add_target_pod(namespace="team-b", uid="uid-team-b")
    rig.provision_container(team_b)
    out = [norm_result(pkg.add(rig.service, "workload", "team-b", 2,
                               True).result)]
    out.append(pkg.status(rig.service, "workload", "default")[0].name)
    out.append(norm_result(pkg.remove(rig.service, "workload", "default",
                                      [], False).result))
    out.append(norm_result(pkg.add(rig.service, "workload", "default", 2,
                                   True).result))
    _, mine = pkg.status(rig.service, "workload", "default")
    _, theirs = pkg.status(rig.service, "workload", "team-b")
    out.append((len(mine), len(theirs), {c.device_id for c in mine}
                .isdisjoint({c.device_id for c in theirs})))
    return out


def test_same_pod_name_other_namespace_not_conflated(pkg, rig):
    assert _namespaces(pkg, rig) == ["SUCCESS", "NONE", "NOT_FOUND",
                                     "SUCCESS", (2, 2, True)]


def _txn(pkg, rig) -> list:
    pkg.add(rig.service, "workload", "default", 1, False)
    pkg.add(rig.service, "workload", "default", 1, False, txn_id="txn-abc")
    out = [norm_result(pkg.remove(rig.service, "workload", "default", [],
                                  False, txn_id="txn-abc").result)]
    mount_type, chips = pkg.status(rig.service, "workload", "default")
    out.append((mount_type.name, len(chips)))
    out.append(norm_result(pkg.remove(rig.service, "workload", "default",
                                      [], False, txn_id="txn-ghost").result))
    return out


def test_txn_scoped_removal(pkg, rig):
    """A detach scoped to a transaction leaves the other mounts; an
    unknown transaction is an idempotent no-op."""
    assert _txn(pkg, rig) == ["SUCCESS", ("SINGLE", 1), "NOT_FOUND"]


def _restart(pkg, rig) -> list:
    """A new worker stack over the same cluster and host detaches what the
    previous one attached."""
    added = pkg.add(rig.service, "workload", "default", 2, False)
    fresh = pkg.Service(
        pkg.Allocator(rig.sim.collector, rig.sim.kube, rig.sim.settings),
        getattr(pkg.mod("actuation.mount"),
                "GPUMounter" if pkg is TORCH else "TPUMounter")(
            rig.cgroups, rig.actuator, rig.sim.enumerator, rig.host),
        rig.sim.kube, rig.sim.settings)
    out = [pkg.status(fresh, "workload", "default")[0].name]
    out.append(norm_result(pkg.remove(fresh, "workload", "default",
                                      [c.uuid for c in added.chips],
                                      False).result))
    out.append(len(rig.sim.slave_pods()))
    return out


def test_worker_restart_can_detach_previous_workers_mounts(pkg, rig):
    assert _restart(pkg, rig) == ["SINGLE", "SUCCESS", 0]


@pytest.mark.parametrize("scenario", [_namespaces, _txn, _restart],
                         ids=["namespaces", "txn", "restart"])
def test_reconciler_transcripts_agree(tmp_path, scenario):
    out = {}
    for pkg in (JAX, TORCH):
        rig = pkg.rig(tmp_path / pkg.name)
        try:
            out[pkg.name] = scenario(pkg, rig)
        finally:
            rig.close()
    assert out["torch"] == out["jax"]
