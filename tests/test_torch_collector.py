"""The port's collector against the control plane's: the same kubelet
listings go through ``TPUCollector`` over an ``accelN`` fixture tree and
through ``GPUCollector`` over an ``nvidiaN`` tree (with the shared
companions and the driver's UUIDs), device ``i`` of one matched with
device ``i`` of the other. Then what only GPUs have (the UUID-less node,
an empty id), and the gRPC client against the port's fake kubelet over a
short unix-socket path, v1 and the v1alpha1 fallback, in both directions
between the two packages."""

import os

import pytest

from gpumounter_tpu.collector.collector import TPUCollector
from gpumounter_tpu.collector.fake_kubelet import \
    FakeKubeletServer as JaxKubeletServer
from gpumounter_tpu.collector.podresources import \
    FakePodResourcesClient as JaxFakeClient
from gpumounter_tpu.collector.podresources import \
    KubeletPodResourcesClient as JaxKubeletClient
from gpumounter_tpu.device.enumerator import PyEnumerator as JaxEnumerator
from gpumounter_tpu.utils import consts as jax_consts
from gpumounter_tpu.utils.config import HostPaths as JaxHostPaths
from gpumounter_tpu.utils.metrics import REGISTRY as JAX_REGISTRY
from gpumounter_tpu_torch.collector import fake_kubelet
from gpumounter_tpu_torch.collector.collector import GPUCollector
from gpumounter_tpu_torch.collector.fake_kubelet import FakeKubeletServer
from gpumounter_tpu_torch.collector.podresources import (
    FakePodResourcesClient, KubeletPodResourcesClient, PodResourcesListing)
from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.device.fake import fake_uuid
from gpumounter_tpu_torch.device.model import DeviceState
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import KubeletUnavailableError
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from test_torch_device import gpu_host, make_gpu_tree  # noqa: F401

POOL = "gpu-pool"


class Side:
    """One package's collector over its fixture tree, addressed by device
    index."""

    def __init__(self, collector, kubelet, registry, ids, resource):
        self.collector = collector
        self.kubelet = kubelet
        self.registry = registry
        self.ids = ids                   # index -> kubelet device id
        self.resource = resource
        self.index = {v: k for k, v in ids.items()}

    def assign(self, namespace, pod, indices, resource=None):
        self.kubelet.assign(namespace, pod, [self.id(i) for i in indices],
                            resource=resource or self.resource)

    def id(self, i):
        return self.ids.get(i, f"missing-{i}")

    def state(self):
        """index -> (state, pod, namespace) of every device."""
        return {self.index[c.uuid]: (c.state.value, c.pod_name, c.namespace)
                for c in self.collector.chips}

    def indices(self, chips):
        return sorted(self.index[c.uuid] for c in chips)

    def gauges(self):
        return {s: self.registry.chips.value(state=s)
                for s in ("free", "allocated")}


def _jax_side(root, n):
    host = JaxHostPaths(dev_root=str(root / "jdev"),
                        proc_root=str(root / "jproc"),
                        sys_root=str(root / "jsys"))
    for d in (host.dev_root, host.proc_root, host.sys_root):
        os.makedirs(d)
    for i in range(n):
        path = os.path.join(host.dev_root, f"accel{i}")
        open(path, "w").close()
        with open(path + ".majmin", "w") as f:
            f.write(f"120:{i}")
    kubelet = JaxFakeClient()
    coll = TPUCollector(JaxEnumerator(host, allow_fake=True), kubelet,
                        pool_namespace=POOL)
    return Side(coll, kubelet, JAX_REGISTRY, {i: str(i) for i in range(n)},
                jax_consts.TPU_RESOURCE_NAME)


def _torch_side(host, n):
    make_gpu_tree(host, range(n))
    kubelet = FakePodResourcesClient()
    coll = GPUCollector(PyEnumerator(host, allow_fake=True), kubelet,
                        pool_namespace=POOL)
    return Side(coll, kubelet, REGISTRY, {i: fake_uuid(i) for i in range(n)},
                consts.GPU_RESOURCE_NAME)


@pytest.fixture
def both(tmp_path, gpu_host):          # noqa: F811
    return _jax_side(tmp_path, 4), _torch_side(gpu_host, 4)


def _each(both, fn):
    """fn(side) on both sides; returns the two results."""
    return [fn(side) for side in both]


def test_initial_inventory_all_free(both):
    jax, torch = _each(both, lambda s: s.state())
    assert jax == torch == {i: ("FREE", "", "") for i in range(4)}
    gpus = both[1].collector.chips
    assert {(g.major, len(g.companions)) for g in gpus} == {(195, 3)}


def test_update_status_marks_allocated(both):
    def run(side):
        side.assign("default", "train-pod", [1, 2])
        side.collector.update_status()
        return side.state()
    jax, torch = _each(both, run)
    assert jax == torch
    assert torch[1] == ("ALLOCATED", "train-pod", "default")
    assert torch[0] == ("FREE", "", "")


def test_update_status_resets_stale_bindings(both):
    def run(side):
        side.assign("default", "train-pod", [1])
        side.collector.update_status()
        side.kubelet.unassign("default", "train-pod")
        side.collector.update_status()
        return side.state()
    jax, torch = _each(both, run)
    assert jax == torch == {i: ("FREE", "", "") for i in range(4)}


def test_other_resources_are_ignored(both):
    """Each collector counts only its own resource: the port ignores
    ``google.com/tpu``, the control plane ``nvidia.com/gpu``."""
    def run(side):
        other = (jax_consts.TPU_RESOURCE_NAME
                 if side.resource == consts.GPU_RESOURCE_NAME
                 else consts.GPU_RESOURCE_NAME)
        side.assign("default", "other-pod", [0], resource=other)
        side.collector.update_status()
        return side.state()
    jax, torch = _each(both, run)
    assert jax == torch and torch[0] == ("FREE", "", "")


def test_unknown_device_id_is_skipped(both, caplog):
    def run(side):
        side.kubelet.assign("default", "p", ["GPU-not-on-this-node",
                                             side.id(3)],
                            resource=side.resource)
        side.collector.update_status()
        return side.state()
    jax, torch = _each(both, run)
    assert jax == torch
    assert torch[3] == ("ALLOCATED", "p", "default")
    assert "unknown device 'GPU-not-on-this-node'" in caplog.text


def test_exact_aggregation_includes_named_slave_pods(both):
    def run(side):
        side.assign("default", "train-pod", [0])
        side.assign(POOL, "train-pod-slave-pod-a1b2c3", [1])
        side.assign(POOL, "warm-slave-pod-d4e5f6", [2])
        side.assign(POOL, "other-slave-pod-ffffff", [3])
        names = {"train-pod-slave-pod-a1b2c3", "warm-slave-pod-d4e5f6"}
        if isinstance(side.collector, GPUCollector):
            chips = side.collector.get_pod_gpu_resources_exact(
                "train-pod", "default", names)
        else:
            chips = side.collector.get_pod_tpu_resources_exact(
                "train-pod", "default", names)
        own = side.collector.get_pod_chips("train-pod", "default",
                                           refresh=False)
        return side.indices(chips), side.indices(own)
    jax, torch = _each(both, run)
    assert jax == torch == ([0, 1, 2], [0])


def test_same_slave_name_in_another_namespace_is_not_aggregated(both):
    def run(side):
        side.assign("elsewhere", "train-pod-slave-pod-a1b2c3", [1])
        if isinstance(side.collector, GPUCollector):
            get = side.collector.get_pod_gpu_resources_exact
        else:
            get = side.collector.get_pod_tpu_resources_exact
        return side.indices(get("train-pod", "default",
                                {"train-pod-slave-pod-a1b2c3"}))
    jax, torch = _each(both, run)
    assert jax == torch == []


def test_mark_released_writes_through_without_a_list(both):
    def run(side):
        side.assign(POOL, "w-slave-pod-1", [0, 1])
        side.collector.update_status()
        lists = side.kubelet.list_calls
        side.collector.mark_released([side.id(0), "no-such-device"])
        return side.state(), side.kubelet.list_calls - lists, side.gauges()
    jax, torch = _each(both, run)
    assert jax == torch
    state, lists, gauges = torch
    assert state[0] == ("FREE", "", "") and state[1][0] == "ALLOCATED"
    assert lists == 0
    assert gauges == {"free": 3, "allocated": 1}


def test_allocatable_filter_and_gauges(both):
    """A device the kubelet leaves out of its allocatable set is never
    counted free."""
    def run(side):
        side.kubelet.allocatable = {side.resource: [side.id(i)
                                                    for i in (0, 1, 2)]}
        side.assign("default", "p", [2])
        side.collector.update_status()
        return side.gauges()
    jax, torch = _each(both, run)
    assert jax == torch == {"free": 2, "allocated": 1}


def test_plans_rebuild_only_when_the_inventory_changes(both):
    def run(side):
        builds = side.collector.plans.builds
        side.collector.update_status()
        side.collector.update_status()
        return side.collector.plans.builds - builds, len(
            side.collector.plans)
    jax, torch = _each(both, run)
    assert jax == torch == (0, 4)


def test_topology_stamps_survive_a_refresh(both):
    def run(side):
        chip = side.collector.get_chip_by_uuid(side.id(0))
        chip.accelerator, chip.topology = "acc", "2x2"
        side.collector.update_status()
        again = side.collector.get_chip_by_uuid(side.id(0))
        return again.accelerator, again.topology
    jax, torch = _each(both, run)
    assert jax == torch == ("acc", "2x2")


def test_a_gpu_node_without_uuid_never_matches_and_is_never_free(gpu_host):  # noqa: F811
    """A node no driver source names (uuid "") stays out of the
    inventory: an empty kubelet id does not match it, the gauge counts it
    unidentified and never free, and it gets no actuation plan."""
    make_gpu_tree(gpu_host, range(2))
    open(os.path.join(gpu_host.dev_root, "nvidia7"), "w").close()
    kubelet = FakePodResourcesClient()
    kubelet.assign("default", "p", ["", fake_uuid(7)])
    coll = GPUCollector(PyEnumerator(gpu_host, allow_fake=True), kubelet)
    assert [u.device_path for u in coll.unidentified] == [
        os.path.join(gpu_host.dev_root, "nvidia7")]
    assert sorted(c.minor for c in coll.chips) == [0, 1]
    assert coll.get_chip_by_uuid("") is None
    assert all(c.state is DeviceState.FREE for c in coll.chips)
    assert REGISTRY.chips.value(state="free") == 2
    assert REGISTRY.chips.value(state="unidentified") == 1
    assert len(coll.plans) == 2


def test_listing_from_the_fake_matches_the_wire(tmp_path):
    """The fake's plain listing and the same table through the fake
    kubelet and the gRPC client read alike."""
    state = FakePodResourcesClient()
    state.assign("default", "p", [fake_uuid(0), fake_uuid(1)])
    state.assign(POOL, "q", [fake_uuid(2)], container="side")
    plain = state.list_pods()
    assert isinstance(plain, PodResourcesListing)

    def rows(listing):
        return sorted((p.namespace, p.name, c.name, d.resource_name,
                       tuple(d.device_ids))
                      for p in listing.pod_resources for c in p.containers
                      for d in c.devices)
    with FakeKubeletServer(state=state) as server:
        wire = KubeletPodResourcesClient(server.socket_path,
                                         timeout_s=5).list_pods()
    assert rows(wire) == rows(plain)


def test_default_socket_path_is_short_and_removed(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    server = FakeKubeletServer()
    assert len(server.socket_path) <= fake_kubelet.UNIX_PATH_MAX
    with server:
        assert os.path.exists(server.socket_path)
    assert not os.path.exists(os.path.dirname(server.socket_path))
    with pytest.raises(ValueError, match="107-byte limit"):
        FakeKubeletServer(str(tmp_path / ("d" * 120) / "kubelet.sock"))


def test_grpc_client_v1_lists_and_reports_allocatable():
    with FakeKubeletServer() as server:
        server.state.assign("default", "p", [fake_uuid(0)])
        server.state.allocatable = {consts.GPU_RESOURCE_NAME: [
            fake_uuid(i) for i in range(3)]}
        client = KubeletPodResourcesClient(server.socket_path, timeout_s=5)
        resp = client.list_pods()
        assert client.api_version == "v1"
        assert resp.pod_resources[0].name == "p"
        assert client.allocatable_gpu_ids(consts.GPU_RESOURCE_NAME) == {
            fake_uuid(i) for i in range(3)}


def test_grpc_client_falls_back_to_v1alpha1():
    """An old kubelet (no v1 service) answers UNIMPLEMENTED: the client
    falls back for good and has no allocatable view."""
    with FakeKubeletServer(serve_v1=False) as server:
        server.state.assign("default", "p", [fake_uuid(0), fake_uuid(3)])
        client = KubeletPodResourcesClient(server.socket_path, timeout_s=5)
        resp = client.list_pods()
        assert client.api_version == "v1alpha1"
        assert list(resp.pod_resources[0].containers[0].devices[0]
                    .device_ids) == [fake_uuid(0), fake_uuid(3)]
        assert client.allocatable_gpu_ids(consts.GPU_RESOURCE_NAME) is None
        assert client.list_pods().pod_resources[0].name == "p"
        assert client.api_version == "v1alpha1"


def test_v1_without_allocatable_table_reports_none():
    with FakeKubeletServer() as server:
        client = KubeletPodResourcesClient(server.socket_path, timeout_s=5)
        assert client.allocatable_gpu_ids(consts.GPU_RESOURCE_NAME) is None
        assert client.api_version == "v1"


def test_grpc_client_missing_socket_raises(tmp_path):
    client = KubeletPodResourcesClient(str(tmp_path / "nope.sock"))
    with pytest.raises(KubeletUnavailableError):
        client.list_pods()


@pytest.mark.parametrize("serve_v1", [True, False], ids=["v1", "v1alpha1"])
def test_each_package_reads_the_others_fake_kubelet(serve_v1, gpu_host):  # noqa: F811
    """Wire compatibility: the port's client against the control plane's
    fake kubelet, and the control plane's client against the port's."""
    with FakeKubeletServer(serve_v1=serve_v1) as ours:
        ours.state.assign("default", "p", [fake_uuid(1)])
        theirs = JaxKubeletClient(ours.socket_path, timeout_s=5)
        resp = theirs.list_pods()
        assert theirs.api_version == ("v1" if serve_v1 else "v1alpha1")
        assert list(resp.pod_resources[0].containers[0].devices[0]
                    .device_ids) == [fake_uuid(1)]
    socket_path = os.path.join(os.path.dirname(ours.socket_path) + "-j",
                               "k.sock")
    with JaxKubeletServer(socket_path, serve_v1=serve_v1) as server:
        server.state.assign("default", "p", [fake_uuid(2)],
                            resource=consts.GPU_RESOURCE_NAME)
        make_gpu_tree(gpu_host, range(3))
        coll = GPUCollector(PyEnumerator(gpu_host, allow_fake=True),
                            KubeletPodResourcesClient(socket_path,
                                                      timeout_s=5))
        assert [c.minor for c in coll.get_pod_chips("p", "default",
                                                    refresh=False)] == [2]
    os.rmdir(os.path.dirname(socket_path))


def test_collector_over_real_socket_with_allocatable(gpu_host):  # noqa: F811
    make_gpu_tree(gpu_host, range(4))
    with FakeKubeletServer() as server:
        server.state.allocatable = {consts.GPU_RESOURCE_NAME: [
            fake_uuid(i) for i in range(3)]}
        coll = GPUCollector(
            PyEnumerator(gpu_host, allow_fake=True),
            KubeletPodResourcesClient(server.socket_path, timeout_s=5))
        server.state.assign("default", "p", [fake_uuid(2)])
        coll.update_status()
        assert coll.get_chip_by_uuid(fake_uuid(2)).state is \
            DeviceState.ALLOCATED
        assert REGISTRY.chips.value(state="free") == 2
        assert REGISTRY.chips.value(state="allocated") == 1


def test_fake_listing_survives_concurrent_assignment():
    """The fake kubelet's table is assigned by the scheduler's threads while
    handlers list it; a List must never fail on the table changing under it
    (under a 550-client wave it answered UNKNOWN, "dictionary changed size
    during iteration", and the attach failed INTERNAL). Port only: the
    control plane's fake keeps the race (ROADMAP Queue 3)."""
    import sys
    import threading

    state = FakePodResourcesClient()
    for i in range(400):
        state.assign("default", f"p{i}", [fake_uuid(i)])
    stop = threading.Event()

    def churn():
        i = 400
        while not stop.is_set():
            state.assign("default", f"p{i}", [fake_uuid(i)])
            state.unassign("default", f"p{i - 400}")
            i += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    thread = threading.Thread(target=churn, daemon=True)
    thread.start()
    try:
        for _ in range(200):
            listing = state._list_pods_once()
            assert 399 <= len(listing.pod_resources) <= 401
    finally:
        stop.set()
        thread.join()
        sys.setswitchinterval(interval)
