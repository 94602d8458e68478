"""The port's slave-pod allocator against the control plane's: slave pods
through the scheduler, cleanup on Unschedulable and on timeout, removal
resolution, the event-driven waits (the lost-event window, 410 Gone), the
kubelet-lag retry, and the slave-pod spec itself, equal in both packages
after the GPU mapping (``nvidia.com/gpu`` for ``google.com/tpu``, the
``gpu-pool`` label and namespace, the GPU toleration). Then the GPU group
rules, which have no TPU counterpart: any count from 1 to the node's
allocatable ``nvidia.com/gpu`` forms a group, and a node without the GKE
accelerator label is unconstrained."""

import copy
import json
import time

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_text


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def sim(pkg):
    s = pkg.mod("testing.sim").ClusterSim(n_chips=4)
    yield s
    s.close()


@pytest.fixture
def allocator(pkg, sim):
    return pkg.Allocator(sim.collector, sim.kube, sim.settings)


def _alloc(pkg, allocator, owner, total, per, **kw):
    return getattr(allocator, f"get_available_{pkg.dev}s")(owner, total,
                                                           per, **kw)


def _removable(pkg, allocator, owner, uuids, **kw):
    return getattr(allocator, f"get_removable_{pkg.dev}s")(owner, uuids,
                                                           **kw)


def test_single_mount_allocates_n_slave_pods(pkg, sim, allocator):
    consts, objects = pkg.consts, pkg.mod("k8s.objects")
    owner = sim.add_target_pod()
    chips, slaves = _alloc(pkg, allocator, owner, 2, 1)
    assert (len(chips), len(slaves), len(sim.slave_pods())) == (2, 2, 2)
    for pod in sim.slave_pods():
        labels = objects.labels(pod)
        assert labels[consts.OWNER_POD_LABEL_KEY] == "workload"
        assert labels[consts.MOUNT_TYPE_LABEL_KEY] == "single-mount"
        assert pod["spec"]["nodeSelector"] == {
            "kubernetes.io/hostname": "node-a"}


def test_entire_mount_is_one_slave_pod(pkg, sim, allocator):
    owner = sim.add_target_pod()
    chips, slaves = _alloc(pkg, allocator, owner, 4, 4)
    assert (len(chips), len(slaves)) == (4, 1)
    pod = sim.slave_pods()[0]
    assert pod["spec"]["containers"][0]["resources"]["limits"] == {
        pkg.resource: "4"}


def test_insufficient_devices_clean_up(pkg, sim, allocator):
    owner = sim.add_target_pod()
    with pytest.raises(pkg.Insufficient):
        _alloc(pkg, allocator, owner, 5, 1)
    assert sim.slave_pods() == []
    assert sim.podresources.assignments == {}


def test_allocation_times_out_when_scheduler_never_acts(pkg, sim):
    sim.kube.on_create.clear()
    settings = pkg.mod("utils.config").Settings()
    settings.allocation_timeout_s = 0.3
    allocator = pkg.Allocator(sim.collector, sim.kube, settings)
    owner = sim.add_target_pod()
    with pytest.raises(pkg.errors.AllocationTimeoutError):
        _alloc(pkg, allocator, owner, 1, 1)
    assert sim.slave_pods() == []


def test_removable_resolution_subset_and_unknown(pkg, sim, allocator):
    owner = sim.add_target_pod()
    chips, slaves = _alloc(pkg, allocator, owner, 2, 1)
    uuids = [c.uuid for c in chips]
    got, holders, _ = _removable(pkg, allocator, "workload", [uuids[0]])
    assert [c.uuid for c in got] == [uuids[0]] and len(holders) == 1
    got, holders, _ = _removable(pkg, allocator, "workload", [])
    assert sorted(c.uuid for c in got) == sorted(uuids)
    assert holders == sorted(slaves)
    with pytest.raises(pkg.errors.DeviceNotFoundError):
        _removable(pkg, allocator, "workload", ["no-such-device"])


def test_devices_from_the_pods_own_spec_are_not_removable(pkg, sim,
                                                          allocator):
    sim.podresources.assign("default", "workload", [pkg.uuid(0)],
                            resource=pkg.resource)
    sim.add_target_pod()
    with pytest.raises(pkg.errors.DeviceNotFoundError):
        _removable(pkg, allocator, "workload", [pkg.uuid(0)])


def test_delete_slave_pods_waits_for_termination(pkg, sim, allocator):
    owner = sim.add_target_pod()
    _, slaves = _alloc(pkg, allocator, owner, 2, 1)
    sim.kube.delete_latency_s = 0.1
    assert allocator.delete_slave_pods(slaves) == []
    assert sim.slave_pods() == []


def test_mount_type_from_labels(pkg, sim, allocator):
    mount = pkg.consts.MountType
    owner = sim.add_target_pod()
    assert allocator.get_mount_type("workload") is mount.NONE
    _alloc(pkg, allocator, owner, 2, 2)
    assert allocator.get_mount_type("workload") is mount.ENTIRE


def test_request_id_makes_allocation_idempotent(pkg, sim, allocator):
    """A second call with the same request id adopts the first call's slave
    pods instead of allocating a second set."""
    owner = sim.add_target_pod()
    _, first = _alloc(pkg, allocator, owner, 2, 1, request_id="r1")
    adopt = allocator.request_slave_pods("workload", "default", "r1")
    assert adopt == set(first)
    _, again = _alloc(pkg, allocator, owner, 2, 1, request_id="r1",
                      adopt=adopt)
    assert sorted(again) == sorted(first)
    assert len(sim.slave_pods()) == 2


class _Hook:
    """Fires a callback right after the next LIST returns (the lost-event
    window) and counts GETs (polling detector); can fail the first watch
    with 410 Gone."""

    def __init__(self, pkg):
        base = pkg.mod("k8s.client").FakeKubeClient
        errors = pkg.errors

        class Kube(base):
            after_list = None
            get_calls = 0
            gone_once = False

            def list_pods_with_version(self, namespace, label_selector=None):
                out = super().list_pods_with_version(namespace,
                                                     label_selector)
                hook, self.after_list = self.after_list, None
                if hook:
                    hook()
                return out

            def get_pod(self, namespace, name):
                self.get_calls += 1
                return super().get_pod(namespace, name)

            def watch_pods(self, *args, **kwargs):
                if self.gone_once:
                    self.gone_once = False
                    raise errors.K8sApiError(410, "resourceVersion too old")
                return super().watch_pods(*args, **kwargs)
        self.kube = Kube()
        settings = pkg.mod("utils.config").Settings()
        settings.allocation_timeout_s = 3.0
        self.ns = settings.pool_namespace
        self.allocator = pkg.Allocator(None, self.kube, settings)
        self.label = {pkg.consts.SLAVE_POD_LABEL_KEY:
                      pkg.consts.SLAVE_POD_LABEL_VALUE}

    def put(self, name, phase):
        self.kube.put_pod({"metadata": {"name": name, "namespace": self.ns,
                                        "labels": dict(self.label)},
                           "status": {"phase": phase}})


def test_wait_running_catches_the_event_between_list_and_watch(pkg):
    h = _Hook(pkg)
    h.put("s1", "Pending")
    h.kube.after_list = lambda: h.kube.set_pod_status(h.ns, "s1",
                                                      phase="Running")
    h.allocator._wait_running(["s1"])
    assert h.kube.get_calls == 0


def test_wait_deleted_catches_the_event_between_list_and_watch(pkg):
    h = _Hook(pkg)
    h.put("s1", "Running")
    h.kube.after_list = lambda: h.kube.delete_pod(h.ns, "s1")
    h.allocator._wait_deleted(["s1"])
    assert h.kube.get_calls == 0


def test_wait_running_recovers_from_410_gone(pkg):
    h = _Hook(pkg)
    h.put("s1", "Pending")
    h.kube.gone_once = True
    h.kube.after_list = lambda: h.kube.set_pod_status(h.ns, "s1",
                                                      phase="Running")
    h.allocator._wait_running(["s1"])


def test_unschedulable_is_read_from_any_condition(pkg):
    alloc = pkg.mod("allocator.allocator")
    pod = {"status": {"conditions": [
        {"type": "Ready", "status": "False"},
        {"type": "PodScheduled", "status": "False",
         "reason": "Unschedulable"}]}}
    assert alloc.is_unschedulable(pod)
    pod["status"]["conditions"][1]["status"] = "True"
    assert not alloc.is_unschedulable(pod)


def test_kubelet_lag_tolerated_with_bounded_retry(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4, kubelet_lag_s=0.5)
    try:
        out = pkg.add(rig.service, "workload", "default", 4, True)
        assert out.result.name == "SUCCESS" and len(out.chips) == 4
    finally:
        rig.close()


def test_kubelet_lag_beyond_bound_fails_cleanly(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4, kubelet_lag_s=5.0)
    rig.sim.settings.kubelet_lag_timeout_s = 0.3
    try:
        out = pkg.add(rig.service, "workload", "default", 4, True)
        assert out.result.name.startswith("INSUFFICIENT")
        assert "reports no" in out.message
        assert rig.sim.slave_pods() == []
    finally:
        rig.close()


def _spec(pkg, **kw):
    sim = pkg.mod("testing.sim").ClusterSim(n_chips=2)
    try:
        allocator = pkg.Allocator(sim.collector, sim.kube, sim.settings)
        owner = sim.add_target_pod()
        spec = allocator.new_slave_pod(owner, 2, True, txn_id="t1",
                                       extra_labels=kw.get("labels"))
    finally:
        sim.close()
    name = spec["metadata"]["name"]
    prefix = "workload" + pkg.consts.SLAVE_POD_INFIX
    assert name.startswith(prefix) and len(name) == len(prefix) + 6
    spec = copy.deepcopy(spec)
    spec["metadata"]["name"] = prefix + "<hex>"
    return spec


def test_slave_pod_specs_equal_after_the_gpu_mapping():
    """The same owner and request give the same slave pod in both
    packages, once the device words are mapped to roles."""
    jax_spec, torch_spec = _spec(JAX), _spec(TORCH)
    assert norm_text(json.dumps(jax_spec, sort_keys=True)) == \
        norm_text(json.dumps(torch_spec, sort_keys=True))
    assert torch_spec["spec"]["tolerations"] == [{
        "key": "nvidia.com/gpu", "operator": "Exists",
        "effect": "NoSchedule"}]
    assert torch_spec["metadata"]["labels"]["app"] == "gpu-pool"
    assert torch_spec["metadata"]["namespace"] == "gpu-pool"
    assert torch_spec["spec"]["containers"][0]["image"] == \
        "registry.k8s.io/pause:3.9"


def test_owner_reference_only_within_the_pool_namespace(pkg):
    """An ownerReference where the owner lives in the pool namespace (the
    GC ignores cross-namespace ones); the owner labels always."""
    sim = pkg.mod("testing.sim").ClusterSim(n_chips=1)
    try:
        allocator = pkg.Allocator(sim.collector, sim.kube, sim.settings)
        other = sim.add_target_pod()
        same = sim.add_target_pod(name="w2",
                                  namespace=sim.settings.pool_namespace)
        assert allocator.owner_references(other) == []
        (ref,) = allocator.owner_references(same)
        assert (ref["kind"], ref["name"], ref["uid"]) == ("Pod", "w2",
                                                          "uid-w")
        spec = allocator.new_slave_pod(same, 1, False)
        assert spec["metadata"]["ownerReferences"] == [ref]
    finally:
        sim.close()


# -- GPU group rules (allocator/topology.py) ----------------------------------

TOPOLOGY = TORCH.mod("allocator.topology")
MAKE_NODE = TORCH.mod("testing.sim").make_gpu_node


@pytest.mark.parametrize("gpus", [1, 2, 4, 8])
def test_group_rule_table(gpus):
    """An A3-style node with ``gpus`` GPUs behind NVSwitch: every count
    from 1 to ``gpus`` is a group, one more is not."""
    topo = TOPOLOGY.node_topology(MAKE_NODE(gpus=gpus))
    assert (topo.accelerator, topo.gpus_per_node) == ("nvidia-h100-80gb",
                                                      gpus)
    assert not topo.multi_host and topo.num_hosts == 1
    assert TOPOLOGY.aligned_group_sizes(topo) == list(range(1, gpus + 1))
    for n in range(1, gpus + 1):
        TOPOLOGY.validate_entire_mount(topo, n)
    with pytest.raises(TORCH.errors.TopologyError, match="valid sizes"):
        TOPOLOGY.validate_entire_mount(topo, gpus + 1)
    assert topo.slave_pod_labels() == {
        "tpumounter.io/gpu-accelerator": "nvidia-h100-80gb"}


def test_unlabelled_node_is_unconstrained():
    assert TOPOLOGY.node_topology(MAKE_NODE(accelerator=None)) is None
    assert TOPOLOGY.node_topology(None) is None
    TOPOLOGY.validate_entire_mount(None, 64)
    # a label without a readable count is unconstrained too
    node = MAKE_NODE()
    node["status"]["allocatable"] = {}
    topo = TOPOLOGY.node_topology(node)
    assert topo.gpus_per_node == 0
    TOPOLOGY.validate_entire_mount(topo, 64)


def test_tpu_labels_do_not_make_a_gpu_group():
    """A node carrying only the TPU labels is not a GPU node to the port."""
    node = MAKE_NODE(accelerator=None)
    node["metadata"]["labels"] = {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
        "cloud.google.com/gke-tpu-topology": "2x2"}
    assert TOPOLOGY.node_topology(node) is None


def _labelled_rig(tmp_path, gpus_on_node, n_chips=8):
    rig = TORCH.rig(tmp_path, n_chips=n_chips)
    rig.sim.kube.put_node(MAKE_NODE(gpus=gpus_on_node))
    return rig


@pytest.mark.parametrize("n,ok", [(3, True), (8, True), (9, False)])
def test_entire_mount_against_the_node(tmp_path, n, ok):
    """Through the worker: a 3-GPU entire mount on an 8-GPU node is fine
    (it would be refused on a TPU host), 9 is a precondition failure
    before any slave pod exists, and the GPUs carry the accelerator."""
    rig = _labelled_rig(tmp_path, 8, n_chips=9)
    try:
        if ok:
            out = rig.service.add_gpu("workload", "default", n, True)
            assert out.result.name == "SUCCESS" and len(out.chips) == n
            assert {c.accelerator for c in out.chips} == {
                "nvidia-h100-80gb"}
            (slave,) = rig.sim.slave_pods()
            assert slave["metadata"]["labels"][
                "tpumounter.io/gpu-accelerator"] == "nvidia-h100-80gb"
        else:
            with pytest.raises(TORCH.errors.TopologyError):
                rig.service.add_gpu("workload", "default", n, True)
            assert rig.sim.slave_pods() == []
    finally:
        rig.close()


def test_node_topology_is_cached_per_node(tmp_path):
    rig = _labelled_rig(tmp_path, 8)
    try:
        calls = []
        get_node = rig.sim.kube.get_node
        rig.sim.kube.get_node = lambda name: calls.append(name) or \
            get_node(name)
        owner = rig.pod
        for _ in range(3):
            rig.allocator.node_topology_of(owner)
        assert calls == ["node-a"]
        # a node that cannot be read disables the rule for a short while
        rig.allocator._topo_cache.clear()
        rig.sim.kube.get_node = lambda name: (_ for _ in ()).throw(
            TORCH.errors.K8sApiError(503, "down"))
        t0 = time.monotonic()
        assert rig.allocator.node_topology_of(owner) is None
        expiry, topo = rig.allocator._topo_cache["node-a"]
        assert topo is None and expiry - t0 <= 16.0
    finally:
        rig.close()
