"""The group rule of an entire mount and of a slice, through both packages
(the counterpart of tests/test_topology.py, written by hand: the rule
follows the device). A TPU node advertises a mesh (``2x2``, ``2x2x4``)
and an entire mount must be an aligned group of it; a GPU node advertises
its accelerator and allocatable ``nvidia.com/gpu``, one NVSwitch domain,
and any count from 1 to that number is a group (ROADMAP Queue 3 item 24).
Each scenario runs on each package's own node: a refusal comes before any
slave pod, as a 412 over HTTP. Mesh strings and multi-host slices have no
GPU meaning (Queue 3)."""

import json
import urllib.error
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH, norm_result
from tests.torch_slices import post


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _node(pkg, name="node-a", accelerator="default", devices=4):
    """A labelled node of ``devices`` devices (mesh ``2x2`` for 4 TPU
    chips, ``2x4`` for 8), or a label-less one."""
    sim = pkg.mod("testing.sim")
    if pkg is TORCH:
        return sim.make_gpu_node(
            name=name, gpus=devices,
            accelerator=("nvidia-h100-80gb" if accelerator == "default"
                         else accelerator))
    return sim.make_tpu_node(
        name=name, chips=devices,
        topology={2: "1x2", 4: "2x2", 8: "2x4"}.get(devices, ""),
        accelerator=("tpu-v5-lite-podslice" if accelerator == "default"
                     else accelerator))


def _topology(pkg):
    return pkg.mod("allocator.topology")


# -- the rule ------------------------------------------------------------------

def test_node_topology_reads_labels_and_allocatable(pkg):
    topo = _topology(pkg).node_topology(_node(pkg, devices=8))
    per_host = topo.gpus_per_node if pkg is TORCH else topo.chips_per_host
    assert (per_host, topo.num_hosts, topo.multi_host) == (8, 1, False)
    assert topo.accelerator == ("nvidia-h100-80gb" if pkg is TORCH
                                else "tpu-v5-lite-podslice")


def test_node_topology_none_for_unlabelled_nodes(pkg):
    topology = _topology(pkg)
    assert topology.node_topology(_node(pkg, accelerator=None)) is None
    assert topology.node_topology(None) is None


def test_aligned_group_sizes_single_host(pkg):
    topology = _topology(pkg)
    sizes = topology.aligned_group_sizes(
        topology.node_topology(_node(pkg, devices=8)))
    assert sizes == (list(range(1, 9)) if pkg is TORCH else [1, 2, 4, 8])


def test_validate_entire_mount(pkg):
    topology = _topology(pkg)
    topo = topology.node_topology(_node(pkg, devices=4))
    topology.validate_entire_mount(topo, 4)          # the whole host
    topology.validate_entire_mount(topo, 2)
    topology.validate_entire_mount(None, 3)          # no label: free
    too_many = 5 if pkg is TORCH else 3              # 3 is no 2x2 group
    with pytest.raises(pkg.errors.TopologyError) as exc:
        topology.validate_entire_mount(topo, too_many)
    assert "valid sizes" in str(exc.value)


# -- through the worker ---------------------------------------------------------

@pytest.fixture
def rig(pkg, tmp_path):
    r = pkg.rig(tmp_path, n_chips=4)
    yield r
    r.close()


def _refused_size(pkg):
    """An entire mount the labelled node refuses: more GPUs than the
    2-GPU node advertises, or 3 chips, which no 2x2 group has."""
    return (3, _node(pkg, devices=2)) if pkg is TORCH else \
        (3, _node(pkg, devices=4))


def test_misaligned_entire_mount_rejected_before_slave_pods(pkg, rig):
    n, node = _refused_size(pkg)
    rig.sim.kube.put_node(node)
    with pytest.raises(pkg.errors.TopologyError):
        pkg.add(rig.service, "workload", "default", n, True)
    assert rig.sim.slave_pods() == []


def test_aligned_entire_mount_stamps_the_accelerator(pkg, rig):
    rig.sim.kube.put_node(_node(pkg, devices=4))
    outcome = pkg.add(rig.service, "workload", "default", 4, True)
    assert norm_result(outcome.result) == "SUCCESS"
    topo = _topology(pkg).node_topology(_node(pkg, devices=4))
    assert {c.accelerator for c in outcome.chips} == {topo.accelerator}
    (slave,) = rig.sim.slave_pods()
    labels = slave["metadata"]["labels"]
    for key, value in topo.slave_pod_labels().items():
        assert labels[key] == value


@pytest.mark.parametrize("node", ["unlabelled", "missing"])
def test_unlabelled_or_missing_node_unconstrained(pkg, rig, node):
    if node == "unlabelled":
        rig.sim.kube.put_node(_node(pkg, accelerator=None))
    outcome = pkg.add(rig.service, "workload", "default", 3, True)
    assert norm_result(outcome.result) == "SUCCESS"


def test_single_mounts_not_topology_constrained(pkg, rig):
    n, node = _refused_size(pkg)
    rig.sim.kube.put_node(node)
    outcome = pkg.add(rig.service, "workload", "default", n, False)
    assert norm_result(outcome.result) == "SUCCESS"
    labels = _topology(pkg).node_topology(node).slave_pod_labels()
    for pod in rig.sim.slave_pods():           # still stamped
        for key, value in labels.items():
            assert pod["metadata"]["labels"][key] == value


def test_misaligned_mount_is_412_over_http(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4)
    n, node = _refused_size(pkg)
    rig.sim.kube.put_node(node)
    stack = pkg.mod("testing.sim").LiveStack(rig)
    try:
        url = stack.base + pkg.fmt(
            f"/add{{dev}}/namespace/default/pod/workload/{{dev}}/{n}/"
            "isEntireMount/true")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url)
        assert exc.value.code == 412
        body = json.loads(exc.value.read())
        assert body["result"] == "FAILED_PRECONDITION"
        assert "valid sizes" in body["message"]
        assert rig.sim.slave_pods() == []
    finally:
        stack.close()


# -- a slice -------------------------------------------------------------------

@pytest.fixture
def stack(pkg, tmp_path):
    s = pkg.mod("testing.sim").MultiNodeStack(
        [pkg.host(tmp_path / f"node{i}") for i in range(2)], n_chips=4)
    yield s
    s.close()


def _slice(pkg, stack, per_host=4):
    body = {"pods": [{"namespace": "default", "pod": f"workload-{i}"}
                     for i in range(2)],
            pkg.fmt("{dev}sPerHost"): per_host}
    return post(stack.base + pkg.fmt("/add{dev}slice"), body)


def test_slice_attach_mismatched_accelerators_412(pkg, stack):
    other = "nvidia-l4" if pkg is TORCH else "tpu-v5p-slice"
    stack.master_kube.put_node(_node(pkg, "node-0"))
    stack.master_kube.put_node(_node(pkg, "node-1", accelerator=other))
    status, body = _slice(pkg, stack)
    assert (status, body["result"]) == (412, "TopologyMismatch")
    assert "different" in body["message"]
    for rig in stack.rigs:
        assert rig.sim.slave_pods() == []


def test_slice_attach_wrong_per_host_count_412(pkg, stack):
    for i in range(2):
        stack.master_kube.put_node(_node(pkg, f"node-{i}"))
    status, body = _slice(pkg, stack, per_host=2)
    assert status == 412 and "whole hosts" in body["message"]


def test_slice_attach_two_pods_one_host_412(pkg, stack):
    pod = stack.master_kube.get_pod("default", "workload-1")
    pod["spec"]["nodeName"] = "node-0"
    stack.master_kube.put_pod(pod)
    status, body = _slice(pkg, stack)
    assert status == 412 and "one pod per host" in body["message"]


def test_slice_attach_matching_hosts_succeeds(pkg, stack):
    for i in range(2):
        stack.master_kube.put_node(_node(pkg, f"node-{i}"))
    status, body = _slice(pkg, stack)
    assert (status, body["result"]) == (200, "SUCCESS")
