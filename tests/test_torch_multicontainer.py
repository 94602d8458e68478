"""Pods with two containers, through both packages (the counterpart of
tests/test_multicontainer.py): actuation and busy detection cover every
container, not the first one only (the reference read ``pids[0]`` of the
first container, util.go:50). What only GPUs have: the companions every
GPU shares are created once in each container, never twice."""

import collections
import os

import pytest

from tests.torch_control_plane import (BOTH, IDS, JAX, TORCH, norm_path,
                                       norm_result)

CID_MAIN = "containerd://" + "ab" * 32
CID_SIDE = "containerd://" + "cd" * 32
COMPANIONS = {"ctl", "uvm", "uvm-tools"}


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def make_two_container_pod(pkg, name="multi", uid="uid-multi"):
    pod = pkg.mod("testing.sim").make_target_pod(
        name=name, container_id=CID_MAIN, uid=uid)
    pod["spec"]["containers"].append({"name": "side", "resources": {}})
    pod["status"]["containerStatuses"].append(
        {"name": "side", "containerID": CID_SIDE})
    return pod


@pytest.fixture
def rig(pkg, tmp_path):
    r = pkg.rig(tmp_path, n_chips=4)
    yield r
    r.close()


@pytest.fixture
def multi_pod(rig, pkg):
    pod = make_two_container_pod(pkg)
    rig.sim.kube.put_pod(pod)
    return pod, rig.provision_container(pod)


def _nodes_by_pid(entries) -> dict[int, list[str]]:
    out = collections.defaultdict(list)
    for entry in entries:
        out[entry[0]].append(norm_path(entry[1]))
    return {pid: sorted(v) for pid, v in out.items()}


def test_mount_actuates_every_container(pkg, rig, multi_pod):
    pod, pids = multi_pod
    outcome = pkg.add(rig.service, "multi", "default", 2, True)
    assert norm_result(outcome.result) == "SUCCESS"
    by_pid = _nodes_by_pid(rig.actuator.created)
    assert set(by_pid) == set(pids.values())     # nodes in BOTH containers
    want = ["dev0", "dev1"] + (sorted(COMPANIONS) if pkg is TORCH else [])
    for nodes in by_pid.values():                # companions once in each
        assert nodes == sorted(want)
    for cid in (CID_MAIN, CID_SIDE):
        allow = rig.cgroups.container_dir(pod, cid) + "/devices.allow"
        with open(allow) as f:
            assert f"c {pkg.major}:" in f.read()


def test_holder_in_second_container_blocks_detach(pkg, rig, multi_pod):
    pod, pids = multi_pod
    outcome = pkg.add(rig.service, "multi", "default", 2, True)
    side_pid = pids[CID_SIDE]
    rig.sim.enumerator.busy_pids = {outcome.chips[0].device_path:
                                    [side_pid]}
    result = pkg.remove(rig.service, "multi", "default", [], force=False)
    assert norm_result(result.result) == "BUSY"
    assert result.busy_pids == [side_pid]
    assert len(rig.sim.slave_pods()) == 1            # nothing detached


def test_pod_device_processes_sees_all_containers(pkg, rig, multi_pod):
    pod, pids = multi_pod
    chip = pkg.add(rig.service, "multi", "default", 1, True).chips[0]
    rig.sim.enumerator.busy_pids = {
        chip.device_path: [pids[CID_MAIN], pids[CID_SIDE]]}
    holders = rig.mounter.pod_device_processes(pod, chip)
    assert sorted(holders) == sorted(pids.values())


def test_force_detach_kills_holder_in_second_container(pkg, rig, multi_pod):
    pod, pids = multi_pod
    outcome = pkg.add(rig.service, "multi", "default", 2, True)
    side_pid = pids[CID_SIDE]
    rig.sim.enumerator.busy_pids = {outcome.chips[0].device_path:
                                    [side_pid]}
    result = pkg.remove(rig.service, "multi", "default", [], force=True)
    assert norm_result(result.result) == "SUCCESS"
    assert (side_pid, 9) in rig.actuator.killed
    by_pid = _nodes_by_pid(rig.actuator.removed)
    assert set(by_pid) == set(pids.values())     # gone from both
    for nodes in by_pid.values():
        assert [n for n in nodes if n not in COMPANIONS] == ["dev0", "dev1"]


def test_dead_sidecar_does_not_block_actuation(pkg, rig):
    """A terminated sidecar keeps its containerID in the pod status but has
    no cgroup: actuation skips it and serves the live container."""
    pod = make_two_container_pod(pkg, name="deadside", uid="uid-deadside")
    rig.sim.kube.put_pod(pod)
    cgroup_dir = rig.cgroups.container_dir(pod, CID_MAIN)
    os.makedirs(cgroup_dir, exist_ok=True)
    with open(os.path.join(cgroup_dir, "cgroup.procs"), "w") as f:
        f.write("7777\n")
    os.makedirs(os.path.join(rig.host.proc_root, "7777", "root", "dev"),
                exist_ok=True)
    outcome = pkg.add(rig.service, "deadside", "default", 2, True)
    assert norm_result(outcome.result) == "SUCCESS"
    assert {entry[0] for entry in rig.actuator.created} == {7777}
    result = pkg.remove(rig.service, "deadside", "default", [], force=False)
    assert norm_result(result.result) == "SUCCESS"


def _transcript(pkg, tmp_path) -> list:
    """Attach, a sidecar holder, the refused and the forced detach, as
    roles: what both packages must agree on."""
    rig = pkg.rig(tmp_path, n_chips=4)
    try:
        pod = make_two_container_pod(pkg)
        rig.sim.kube.put_pod(pod)
        pids = rig.provision_container(pod)
        role = {pids[CID_MAIN]: "main", pids[CID_SIDE]: "side"}
        added = pkg.add(rig.service, "multi", "default", 2, True)
        out = [norm_result(added.result),
               sorted((role[pid], [n for n in nodes if n not in COMPANIONS])
                      for pid, nodes in
                      _nodes_by_pid(rig.actuator.created).items())]
        rig.sim.enumerator.busy_pids = {added.chips[1].device_path:
                                        [pids[CID_SIDE]]}
        refused = pkg.remove(rig.service, "multi", "default", [], False)
        out.append((norm_result(refused.result),
                    [role[p] for p in refused.busy_pids]))
        forced = pkg.remove(rig.service, "multi", "default", [], True)
        out.append((norm_result(forced.result),
                    [(role[p], s) for p, s in rig.actuator.killed],
                    len(rig.sim.slave_pods())))
        return out
    finally:
        rig.close()


def test_multicontainer_transcripts_agree(tmp_path):
    assert _transcript(TORCH, tmp_path / "torch") == \
        _transcript(JAX, tmp_path / "jax")
